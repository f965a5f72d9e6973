// The body of the stage-3 sweep kernel's forms (fused_sweep.cu), included
// by fused_sweep_kernel (K1, K1c, K1e) with AM_SCAN_FORM 0 and by
// fused_scan_kernel (K1d) with AM_SCAN_FORM 1.  K1d's additions are
// preprocessor blocks, not `if constexpr`: the other forms compile from
// tokens K1d's code does not touch, so their SASS does not move with it
// (the forms sit at their registers' ceiling, where any change to the code
// around them moved it; PERF.md section 6).
  // ---- tables -> shared memory (stateless form) -------------------------
  // tab = [sig K*D | loglam K*L | abase K*L | logdet K*L | mu K*L*D |
  //        binv K*L*D*D | B K*L*D*D]
  constexpr bool kCache = cached_shape<K, D>();
  extern __shared__ float smem[];
  __shared__ float consts_s[K * AM_N_CONSTS];
  __shared__ int kinds_s[K];
  __shared__ int dims_s[K];
  __shared__ int hist_s[K];
  const int KL = K * L;
  const int n_tab = K * D + 3 * KL + KL * D + 2 * KL * D * D;
  if constexpr (!kCache)
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x) smem[i] = tab[i];
  else
    am_ddi_shared_load(smem, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < K * AM_N_CONSTS; i += blockDim.x)
    consts_s[i] = consts_g[i];
  for (int m = threadIdx.x; m < K; m += blockDim.x) {
    kinds_s[m] = kinds_g[m];
    dims_s[m] = dims_g[m];
    hist_s[m] = 0;
  }
  __syncthreads();
  const float* sig = kCache ? tab : smem;
  const float* loglam = sig + K * D;
  const float* abase = loglam + KL;
  const float* logdet = abase + KL;
  const float* mu = logdet + KL;
  const float* binv = mu + KL * D;
  const float* Bm = binv + KL * D * D;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < S;
#if AM_SCAN_FORM
  // K1d: the grid's threads, and this thread's chains below S (none past
  // S: such a thread joins every barrier and counts nothing)
  const int G = gridDim.x * blockDim.x;
  const int nc = valid ? (S - 1 - i) / G + 1 : 0;
#else
  if (!kPooled && !valid) return;
  const int ci = valid ? i : 0;    // K1c: threads past S copy chain 0
#endif

  // ---- chain state into registers -----------------------------------------
#if AM_SCAN_FORM
  // K1d: each chain's k, theta and logp at each sweep (below); pk, pkllim
  // and nreinit the shared ones
  int kk = 0;
  float th[D] = {};
  float lp = 0.0f;
  float pk[K];
#pragma unroll
  for (int m = 0; m < K; ++m) pk[m] = pk_in[m];
  float pkl = pkl_in[0];
  int nri = nri_in[0];
#else
  int kk = k_in[ci];
  float th[D];
#pragma unroll
  for (int d = 0; d < D; ++d) th[d] = th_in[d * S + ci];
  float lp = lp_in[ci];
  float pk[K];
#pragma unroll
  for (int m = 0; m < K; ++m) pk[m] = pk_in[m * S + ci];
  float pkl = pkl_in[ci];
  int nri = nri_in[ci];
#endif
  // visit counts of every model but the last (the last's is n_sweeps less
  // the others'), theta sums of every model: in registers, or at the small
  // shapes and toy2's in this thread's column of shared memory
  int ks[K];
  constexpr bool kSS = shared_cols<K, D>();
  float ts[kSS ? 1 : K * D], tq[kSS ? 1 : K * D];
  float* sums_s = smem + n_tab + threadIdx.x;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    ks[m] = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if constexpr (kSS) {
        sums_s[(m * D + d) * kThreads] = 0.0f;
        sums_s[(K * D + m * D + d) * kThreads] = 0.0f;
      } else {
        ts[m * D + d] = 0.0f;
        tq[m * D + d] = 0.0f;
      }
    }
  }
  // accepts and tries: block accepts, componentwise accepts and tries, RJ
  // accepts (block tries and sweeps follow from sweep0 and n_sweeps)
  int acc_blk = 0, acc_cw = 0, try_cw = 0, acc_rj = 0;

  // The cached forms: the chain's cache of both models' statistics, fresh at
  // the chunk's start state (a chunk boundary refreshes the cache, not
  // logp), after DDI's coefficient tables in shared memory
  [[maybe_unused]] const auto tab0 = am_ddi_tables<0, true>(smem);
  [[maybe_unused]] const auto tab1 = am_ddi_tables<1, true>(smem);
  [[maybe_unused]] const AmDdiCache<kThreads> cache{
      smem + kAmDdiShared + threadIdx.x};
#if !AM_SCAN_FORM
  if constexpr (kCache) {
    am_ddi_cache_full<0>(tab0, th, cache, false);
    am_ddi_cache_full<1>(tab1, th, cache, false);
  }
#endif

  // Random word slots of one sweep (kernels/fused.py s_* offsets):
  // D accept words, the RJ accept, L + K + L Gumbel words, D permutation
  // keys with perm, then the perturbation words: D Box-Muller pairs (cos
  // for the RWM move, sin for the latent) or, with Student-t, one Bailey
  // pair each for the RWM move and the latent.
  const int s_uacc = D, s_gall = D + 1, s_gmod = D + 1 + L;
  const int s_gcmp = D + 1 + L + K, s_perm = D + 1 + 2 * L + K;
  const int s_bm = s_perm + (kPerm ? D : 0);
  const int NW = s_bm + (kTdist ? 4 * D : 2 * D);
  // the chain's stream: the hash's counter base, or K1f's state seeded at
  // this launch's first sweep (common.cuh); K1d seeds each chain's at each
  // sweep (below)
#if AM_SCAN_FORM
  uint64_t st = 0;
#else
  const uint32_t gi = (uint32_t)chain0 + (uint32_t)i;   // global chain
  uint64_t st = am_stream_init(rng, seed, sweep0, gi, gi * (uint32_t)NW);
#endif
  // RWM perturbation and latent filler of coordinate d this sweep
  auto z_rwm = [&](const AmWords& wd, int d) {
    float u1 = am_u01(wd(s_bm + d));
    float u2 = am_u01(wd(s_bm + D + d));
    if (kTdist) return am_bailey_t(u1, u2, tc);
    return am_bm_radius(u1) * cosf(AM_TWO_PI * u2);
  };
  auto z_lat = [&](const AmWords& wd, int d) {
    if (kTdist)
      return am_bailey_t(am_u01(wd(s_bm + 2 * D + d)),
                         am_u01(wd(s_bm + 3 * D + d)), tc);
    float u1 = am_u01(wd(s_bm + d));
    float u2 = am_u01(wd(s_bm + D + d));
    return am_bm_radius(u1) * sinf(AM_TWO_PI * u2);
  };
  auto lat_lpdf = [&](float w) {
    return kTdist ? am_t_latent(w, tc) : am_normal_latent(w);
  };

  // the allocation logits (am_alloc): after the chunk sums in the thread's
  // shared column at the small shapes and toy2's, else a local array
  float lg_local[kSS ? 1 : kLMax];
  float* lg = kSS ? sums_s + 2 * K * D * kThreads : lg_local;

  // Log-posterior of model m (dimension dm) at x, a candidate of the
  // current state (kk, th).  At rb9's shape the rb9 density goes through
  // the chain's kappa tables, empty at the launch's start, which follow the
  // current state's kappas; sanitized as am_logpost.
  constexpr bool kRb9 = rb9_shape<K, D>();
  [[maybe_unused]] float* rb9_col = smem + n_tab + threadIdx.x;
  if constexpr (kRb9) am_rb9_tab_clear<kThreads>(rb9_col);
  auto logpost = [&](int m, int dm, const float (&x)[D]) {
    if constexpr (kRb9) {
      if (kinds_s[m] == AM_KIND_RB9) {
        uint32_t ca = 0xffffffffu, cb = 0xffffffffu;
        if (kinds_s[kk] == AM_KIND_RB9)
          am_rb9_keys<D>(consts_s + kk * AM_N_CONSTS, th, ca, cb);
        const float v = am_density_rb9_tab<D, kThreads>(
            consts_s + m * AM_N_CONSTS, dm, x, rb9_col, ca, cb);
        return fminf(fmaxf(v, AM_NEG_INF), -AM_NEG_INF);
      }
    }
    return am_logpost<K, D, true, small_shape<K, D>(), !kRb9>(
        kinds_s[m], consts_s + m * AM_N_CONSTS, dm, x);
  };

  for (int tr = 0; tr < n_sweeps; ++tr) {
    const int t = sweep0 + tr;
#if AM_SCAN_FORM
    // K1d: the thread's chains in turn (the body below, not indented for
    // it), each from its state in device memory, with its cache built
    // from theta (logp kept) and its stream seeded at sweep t, as a
    // one-sweep launch has them; hc counts them by model after the sweep
    int hc[K] = {};
    for (int ic = 0; ic < nc; ++ic) {
    const int gc = i + ic * G;
    kk = k_out[gc];
#pragma unroll
    for (int d = 0; d < D; ++d) th[d] = th_out[d * S + gc];
    lp = lp_out[gc];
    if constexpr (kCache) {
      am_ddi_cache_full<0>(tab0, th, cache, false);
      am_ddi_cache_full<1>(tab1, th, cache, false);
    }
    st = am_stream_init(rng, seed, t, (uint32_t)gc,
                        (uint32_t)gc * (uint32_t)NW);
#endif
    const AmWords wd = am_stream_sweep(rng, seed, t, st);
    const int dk = dims_s[kk];

    // ---- (a) within-model move: block every 10th sweep, else per coord --
    if (t % 10 == 0) {
      float prop[D];
#pragma unroll
      for (int d = 0; d < D; ++d)
        prop[d] = (d < dk) ? th[d] + sig[kk * D + d] * z_rwm(wd, d) : th[d];
      float lpn;
      if constexpr (kCache)
        lpn = (kk == 0) ? am_ddi_logpost<0>(prop, tab0)
                        : am_ddi_logpost<1>(prop, tab1);
      else
        lpn = logpost(kk, dk, prop);
      float acc = (am_u01(wd(0)) < am_accept(lpn - lp)) ? 1.0f : 0.0f;
      if constexpr (kCache) {
        if (acc != 0.0f) {
          am_ddi_cache_full<0>(tab0, prop, cache, true);
          am_ddi_cache_full<1>(tab1, prop, cache, true);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) th[d] = th[d] + acc * (prop[d] - th[d]);
      lp = lp + acc * (lpn - lp);
      acc_blk += (int)acc;
    } else if constexpr (kCache) {
      // K1e: coordinates at run time; theta's entries by compare
#pragma unroll 1
      for (int j = 0; j < dk; ++j) {
        float oldj = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d)
          if (d == j) oldj = th[d];
        const float pj = oldj + sig[kk * D + j] * z_rwm(wd, j);
        float prop[D];
#pragma unroll
        for (int d = 0; d < D; ++d) prop[d] = (d == j) ? pj : th[d];
        const float lpn = (kk == 0)
                              ? am_ddi_lp_coord<0>(tab0, j, prop, oldj, cache)
                              : am_ddi_lp_coord<1>(tab1, j, prop, oldj, cache);
        const float acc =
            (am_u01(wd(j)) < am_accept(lpn - lp)) ? 1.0f : 0.0f;
        if (acc != 0.0f) {
          am_ddi_cache_coord<0>(tab0, j, prop, oldj, cache);
          am_ddi_cache_coord<1>(tab1, j, prop, oldj, cache);
        }
#pragma unroll
        for (int d = 0; d < D; ++d)
          if (d == j) th[d] = th[d] + acc * (pj - th[d]);
        lp = lp + acc * (lpn - lp);
        acc_cw += (int)acc;
        try_cw += 1;
      }
    } else {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (j >= dk) continue;
        float prop[D];
#pragma unroll
        for (int d = 0; d < D; ++d) prop[d] = th[d];
        prop[j] = th[j] + sig[kk * D + j] * z_rwm(wd, j);
        float lpn = logpost(kk, dk, prop);
        float acc = (am_u01(wd(j)) < am_accept(lpn - lp)) ? 1.0f : 0.0f;
        th[j] = th[j] + acc * (prop[j] - th[j]);
        lp = lp + acc * (lpn - lp);
        acc_cw += (int)acc;
        try_cw += 1;
      }
    }

    // ---- (b) reversible jump ---------------------------------------------
    // forward allocation over the chain's own model's components
    int l_idx = 0;
    const float log_palloc = am_alloc<K, D>(kk, th, dk, L, abase, mu, binv,
                                            wd, s_gall, true, l_idx, lg);

    // standardized residual of the selected component (recomputed)
    float work[D];
    {
      const int ml = kk * L + l_idx;
#pragma unroll
      for (int r = 0; r < D; ++r) {
        if (r < dk) {
          float w = binv[ml * D * D + r * D] * (th[0] - mu[ml * D]);
#pragma unroll
          for (int c = 1; c <= r; ++c)
            w = w + binv[ml * D * D + r * D + c] * (th[c] - mu[ml * D + c]);
          work[r] = w;
        } else {
          work[r] = 0.0f;
        }
      }
    }

    // destination model kn ~ pk (Gumbel argmax, strict > keeps the first)
    int kn = kk;
    float logratio = 0.0f;
    if (K > 1) {
      float logpk[K];
#pragma unroll
      for (int m = 0; m < K; ++m) logpk[m] = logf(fmaxf(pk[m], 1e-38f));
      float bk = logpk[0] + am_gumbel(am_u01(wd(s_gmod)));
      kn = 0;
#pragma unroll
      for (int m = 1; m < K; ++m) {
        float v = logpk[m] + am_gumbel(am_u01(wd(s_gmod + m)));
        if (v > bk) {
          bk = v;
          kn = m;
        }
      }
      float lpk_k = 0.0f, lpk_kn = 0.0f;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (m == kk) lpk_k = logpk[m];
        if (m == kn) lpk_kn = logpk[m];
      }
      logratio = lpk_k - lpk_kn;
    }
    const int dkn = dims_s[kn];

    // destination component ln ~ lam[kn]
    int ln = 0;
    {
      float bl = loglam[kn * L] + am_gumbel(am_u01(wd(s_gcmp)));
      for (int li = 1; li < L; ++li) {
        float v = loglam[kn * L + li]
                  + am_gumbel(am_u01(wd(s_gcmp + li)));
        if (v > bl) {
          bl = v;
          ln = li;
        }
      }
    }

    // latent dimension matching: coordinates the chain's model lacks are
    // filled with latent draws; the "grow" density reads the latent before
    // the permutation, the "shrink" density after it
    float wf[D];
#pragma unroll
    for (int d = 0; d < D; ++d) wf[d] = (d < dk) ? work[d] : z_lat(wd, d);
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d >= dk && d < dkn) logratio = logratio - lat_lpdf(wf[d]);
    if (kPerm) {
      // random permutation of the first max(dk, dkn) latent slots: a
      // stable bubble network over per-slot uniform keys, inactive slots
      // keyed 1 + d (D passes of D - 1 compare-swaps, as in the TPU kernel)
      const int nact = dk > dkn ? dk : dkn;
      float keys[D];
#pragma unroll
      for (int d = 0; d < D; ++d)
        keys[d] = (d < nact) ? am_u01(wd(s_perm + d)) : 1.0f + (float)d;
#pragma unroll
      for (int pass = 0; pass < D; ++pass) {
#pragma unroll
        for (int j = 0; j < D - 1; ++j) {
          if (keys[j] > keys[j + 1]) {
            const float kt = keys[j];
            keys[j] = keys[j + 1];
            keys[j + 1] = kt;
            const float wt = wf[j];
            wf[j] = wf[j + 1];
            wf[j + 1] = wt;
          }
        }
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < dk && d >= dkn) logratio = logratio + lat_lpdf(wf[d]);

    // de-standardize into the destination model
    float thn[D];
    {
      const int mln = kn * L + ln;
#pragma unroll
      for (int r = 0; r < D; ++r) {
        if (r < dkn) {
          float a = mu[mln * D + r];
#pragma unroll
          for (int c = 0; c <= r; ++c) a = a + Bm[mln * D * D + r * D + c] * wf[c];
          thn[r] = a;
        } else {
          thn[r] = 0.0f;
        }
      }
    }

    // reverse allocation over the destination model's components
    const float log_pallocn = am_alloc<K, D>(kn, thn, dkn, L, abase, mu,
                                             binv, wd, 0, false, ln, lg);

    // MH accept
    float lpn;
    if constexpr (kCache)
      lpn = (kn == 0) ? am_ddi_logpost<0>(thn, tab0)
                      : am_ddi_logpost<1>(thn, tab1);
    else
      lpn = logpost(kn, dkn, thn);
    logratio = logratio + (lpn - lp);
    logratio = logratio + (log_pallocn - log_palloc);
    logratio = logratio + (loglam[kk * L + l_idx] - loglam[kn * L + ln]);
    logratio = logratio + (logdet[kn * L + ln] - logdet[kk * L + l_idx]);
    const float accf =
        (am_u01(wd(s_uacc)) < am_accept(logratio)) ? 1.0f : 0.0f;
    const int acci = (int)accf;
    if constexpr (kCache) {
      if (acci) {
        am_ddi_cache_full<0>(tab0, thn, cache, true);
        am_ddi_cache_full<1>(tab1, thn, cache, true);
      }
    }
    kk = kk + acci * (kn - kk);
#pragma unroll
    for (int d = 0; d < D; ++d) th[d] = th[d] + accf * (thn[d] - th[d]);
    lp = lp + accf * (lpn - lp);
    if constexpr (kCache) {
      // periodic refresh of the cache and logp from the state (keyed on
      // the global sweep, so a resume at a chunk boundary replays it)
      if (t % kRefresh == kRefresh - 1) {
        am_ddi_cache_full<0>(tab0, th, cache, false);
        am_ddi_cache_full<1>(tab1, th, cache, false);
        const auto col0 = [&](int c) { return cache[AmDdi<0>::kOff + c]; };
        const auto col1 = [&](int c) { return cache[AmDdi<1>::kOff + c]; };
        lp = (kk == 0) ? am_ddi_lp<0>(th, col0) : am_ddi_lp<1>(th, col1);
      }
    }

    // ---- (c) pk diminishing adaptation with the re-init safeguard --------
    // (K1d: after its chains' sweeps, below)
#if !AM_SCAN_FORM
    if (adapt && K > 1) {
      // K1c: this sweep's population histogram (header note)
      const int* gh = nullptr;
      if constexpr (kPooled) {
        gh = ghist + (tr % 3) * K;
        const int lane = threadIdx.x & 31;
#pragma unroll
        for (int m = 0; m < K; ++m) {
          const unsigned b = __ballot_sync(0xffffffffu, valid && kk == m);
          if (lane == 0 && b != 0u) atomicAdd(&hist_s[m], __popc(b));
        }
        __syncthreads();
        if (threadIdx.x < K) {
          const int c = hist_s[threadIdx.x];
          hist_s[threadIdx.x] = 0;
          if (c != 0) atomicAdd(ghist + (tr % 3) * K + threadIdx.x, c);
        }
        cooperative_groups::this_grid().sync();
        if (blockIdx.x == 0 && threadIdx.x < K)
          ghist[((tr + 2) % 3) * K + threadIdx.x] = 0;
      }
      const float gamma = am_gain(t);
      float newpk[K];
      bool reinit = false;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        float oh;
        if constexpr (kPooled)
          oh = (float)__ldcg(gh + m) * inv_S;
        else
          oh = (kk == m) ? 1.0f : 0.0f;
        newpk[m] = pk[m] + gamma * (oh - pk[m]);
        reinit = reinit || (newpk[m] < pkl);
      }
      nri += reinit ? 1 : 0;
      if (reinit) pkl = 1.0f / (10.0f * (float)nri);
      const float rf = reinit ? 1.0f : 0.0f;
#pragma unroll
      for (int m = 0; m < K; ++m)
        pk[m] = newpk[m] + rf * ((float)(1.0 / K) - newpk[m]);
    }
#endif

    // ---- chunk statistics -------------------------------------------------
#pragma unroll
    for (int m = 0; m < K - 1; ++m) ks[m] += (m == kk) ? 1 : 0;
    if constexpr (kSS) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float* s1 = sums_s + (kk * D + d) * kThreads;
        float* s2 = sums_s + (K * D + kk * D + d) * kThreads;
        *s1 = *s1 + th[d];
        *s2 = *s2 + th[d] * th[d];
      }
    } else {
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (m != kk) continue;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          ts[m * D + d] = ts[m * D + d] + th[d];
          tq[m * D + d] = tq[m * D + d] + th[d] * th[d];
        }
      }
    }
    acc_rj += acci;
#if AM_SCAN_FORM
#pragma unroll
    for (int m = 0; m < K; ++m) hc[m] += (kk == m) ? 1 : 0;
    k_out[gc] = kk;
#pragma unroll
    for (int d = 0; d < D; ++d) th_out[d * S + gc] = th[d];
    lp_out[gc] = lp;
    }

    // ---- K1d: the shared pk from this sweep's histogram (header note):
    // K1c's histogram and update, the warps summing their threads' counts
    if constexpr (K > 1) {
      int* gh = ghist + (tr % 3) * K;
      const int lane = threadIdx.x & 31;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int n = __reduce_add_sync(0xffffffffu, hc[m]);
        if (lane == 0 && n != 0) atomicAdd(&hist_s[m], n);
      }
      __syncthreads();
      if (threadIdx.x < K) {
        const int c = hist_s[threadIdx.x];
        hist_s[threadIdx.x] = 0;
        if (c != 0) atomicAdd(gh + threadIdx.x, c);
      }
      cooperative_groups::this_grid().sync();
      if (blockIdx.x == 0 && threadIdx.x < K)
        ghist[((tr + 2) % 3) * K + threadIdx.x] = 0;
      const float gamma = am_gain(t);
      float newpk[K];
      bool reinit = false;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        newpk[m] = pk[m] + gamma * ((float)__ldcg(gh + m) * inv_S - pk[m]);
        reinit = reinit || (newpk[m] < pkl);
      }
      nri += reinit ? 1 : 0;
      if (reinit) pkl = 1.0f / (10.0f * (float)nri);
      const float rf = reinit ? 1.0f : 0.0f;
#pragma unroll
      for (int m = 0; m < K; ++m)
        pk[m] = newpk[m] + rf * ((float)(1.0 / K) - newpk[m]);
    }
#endif
  }

  // ---- state and per-chain statistics out -----------------------------------
#if AM_SCAN_FORM
  // K1d: the shared pk, pkllim and nreinit once, and every thread's sums
  // over its chains as column i of [., G] (its chains' state is stored
  // above); the thread's chains swept n_sweeps times each
  if (i == 0) {
#pragma unroll
    for (int m = 0; m < K; ++m) pk_out[m] = pk[m];
    pkl_out[0] = pkl;
    nri_out[0] = nri;
  }
  int ks_last = nc * n_sweeps;
#pragma unroll
  for (int m = 0; m < K - 1; ++m) {
    ks_out[m * G + i] = ks[m];
    ks_last -= ks[m];
  }
  ks_out[(K - 1) * G + i] = ks_last;
#pragma unroll
  for (int j = 0; j < K * D; ++j) {
    if constexpr (kSS) {
      ts_out[j * G + i] = sums_s[j * kThreads];
      tq_out[j * G + i] = sums_s[(K * D + j) * kThreads];
    } else {
      ts_out[j * G + i] = ts[j];
      tq_out[j * G + i] = tq[j];
    }
  }
  const int n_blk = nc * ((sweep0 + n_sweeps + 9) / 10 - (sweep0 + 9) / 10);
  const int cnt[6] = {acc_blk, n_blk, acc_cw, try_cw, acc_rj, nc * n_sweeps};
#pragma unroll
  for (int c = 0; c < 6; ++c) cnt_out[c * G + i] = cnt[c];
#else
  if (!valid) return;
  k_out[i] = kk;
#pragma unroll
  for (int d = 0; d < D; ++d) th_out[d * S + i] = th[d];
  lp_out[i] = lp;
#pragma unroll
  for (int m = 0; m < K; ++m) pk_out[m * S + i] = pk[m];
  pkl_out[i] = pkl;
  nri_out[i] = nri;
  int ks_last = n_sweeps;
#pragma unroll
  for (int m = 0; m < K - 1; ++m) {
    ks_out[m * S + i] = ks[m];
    ks_last -= ks[m];
  }
  ks_out[(K - 1) * S + i] = ks_last;
#pragma unroll
  for (int j = 0; j < K * D; ++j) {
    if constexpr (kSS) {
      ts_out[j * S + i] = sums_s[j * kThreads];
      tq_out[j * S + i] = sums_s[(K * D + j) * kThreads];
    } else {
      ts_out[j * S + i] = ts[j];
      tq_out[j * S + i] = tq[j];
    }
  }
  // sweeps t in [sweep0, sweep0 + n_sweeps) with t % 10 == 0 (block moves)
  const int n_blk = (sweep0 + n_sweeps + 9) / 10 - (sweep0 + 9) / 10;
  const int cnt[6] = {acc_blk, n_blk, acc_cw, try_cw, acc_rj, n_sweeps};
#pragma unroll
  for (int c = 0; c < 6; ++c) cnt_out[c * S + i] = cnt[c];
#endif

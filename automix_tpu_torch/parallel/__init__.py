"""Several devices: the chain axis over torch.distributed ranks."""

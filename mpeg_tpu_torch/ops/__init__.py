"""Device ops: plain PyTorch versions (`video_recon`), the wrappers of
the hand-written CUDA kernels that replace them on the card
(`cuda_kernels`), and the RGBA conversion (`color`)."""

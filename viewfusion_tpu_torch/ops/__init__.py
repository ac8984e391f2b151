"""Ops of the port: the CUDA kernel wrappers and their plain versions,
the schedules and the image metrics (PSNR, SSIM, LPIPS)."""

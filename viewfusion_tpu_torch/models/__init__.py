"""Models of the port: the denoising UNet and the ViewFusion wrapper."""

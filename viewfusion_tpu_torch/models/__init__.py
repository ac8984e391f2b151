"""Models of the port: the denoisers (UNet, DiT) and the ViewFusion
wrapper."""

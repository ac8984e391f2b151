"""More than one process: the (data, view) rank grid, the batch layout,
ZeRO-1 and the collectives (counterpart of ``viewfusion_tpu/parallel``)."""

"""Work counts (FLOPs, bytes) from a configuration's widths, and the
H100's published peaks."""

"""Published peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
700 W power limit): HBM3 bandwidth."""
HBM_BYTES_PER_S = 3.35e12

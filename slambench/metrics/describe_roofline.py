"""``describe_roofline``: the describe stage's share of its roofline.

The bound is the bytes the stage must move at the card's peak bandwidth
(``harness/peaks.py``): every pyramid byte the 40x40 patches cover, once,
and the angle and 256 bits written per keypoint, reckoned by the driver
from the reference's keypoints of the traced frames
(``layer["describe_bytes"]``). The time is the summed device time of the
kernels named below over the same frames. Nothing is read where the
stretch ran no such kernel."""
from slambench.harness.peaks import HBM_BYTES_PER_S

KERNELS = ("describe_kernel",)


def read(layer):
    p = layer.get("profile")
    nbytes = layer.get("describe_bytes")
    if p is None or not nbytes:
        return None
    ns = sum(d for s in p.spans for x in s.launches for n, d in x.kernels
             if any(k in n for k in KERNELS))
    if ns <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (ns / 1e9)

"""``shell_self_ms``: the per-frame shell's own time (``SLAM.process``:
the upload, the replay's launch, the output copy and the host work
between them): the median wall time of the untraced frames that ran no
solve, less the median kernel time of the traced frames' tracking
replay. The wall time comes from the frames before the traced stretch,
because the profiler's own cost lands on the host."""
from slambench.harness.report import median, self_ms


def read(layer):
    p = layer.get("profile")
    if p is None or not layer["untraced_wall_ms"]:
        return None
    kernels = [s.graph_launches()[0].device_ms for s in p.spans
               if s.kind == "frame" and s.index not in layer["ba_frames"]
               and s.graph_launches()]
    if not kernels:
        return None
    return self_ms(median(layer["untraced_wall_ms"]), median(kernels))

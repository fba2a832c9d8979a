"""``elementwise_ms_per_step``: time of PyTorch's elementwise kernels
(the names below) inside the batched step's replays, per traced step."""
NAMES = ("elementwise_kernel", "vectorized_elementwise_kernel",
         "unrolled_elementwise_kernel")


def read(layer):
    p = layer.get("profile")
    if p is None:
        return None
    steps = [s for s in p.spans if s.kind == "step" and s.graph_launches()]
    if not steps:
        return None
    ns = sum(d for s in steps for n, d in s.graph_launches()[0].kernels
             if any(k in n for k in NAMES))
    return ns / 1e6 / len(steps)

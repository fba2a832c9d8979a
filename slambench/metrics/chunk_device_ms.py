"""``chunk_device_ms``: kernel time per frame of the chunk graph's
replays (the first graph a dispatching ``feed`` replays), over the
traced chunks."""


def read(layer):
    p = layer.get("profile")
    if p is None:
        return None
    launches = [s.graph_launches()[0] for s in p.spans
                if s.kind == "dispatch" and s.graph_launches()]
    if not launches:
        return None
    return sum(x.device_ms for x in launches) / (len(launches) * layer["chunk"])

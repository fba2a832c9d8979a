"""``idle_pct``: the share of the traced stretch in which no operation
ran on the device; nothing where none ran at all."""


def read(layer):
    p = layer.get("profile")
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)

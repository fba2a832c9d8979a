"""Set-up pieces the drivers share: the configuration as the program's
and the reference's ``SLAMConfig``, and host copies of the frames."""
from __future__ import annotations

import dataclasses
import gc

import torch


def slam_config(config_module, keys: dict):
    """``config_module.SLAMConfig()`` with ``keys`` set: a top-level key
    takes a value, a section (``orb``, ``ba``, ...) a dict of its keys."""
    cfg = config_module.SLAMConfig()
    top = {}
    for k, v in keys.items():
        if isinstance(v, dict):
            top[k] = dataclasses.replace(getattr(cfg, k), **v)
        else:
            top[k] = v
    return dataclasses.replace(cfg, **top)


def config_dict(ctx) -> dict:
    """The configuration with the test overrides: a section (a dict) is
    merged key by key, any other value replaced."""
    cfg = dict(ctx.cell.config)
    for k, v in (ctx.overrides or {}).items():
        cfg[k] = {**cfg.get(k, {}), **v} if isinstance(v, dict) else v
    return cfg


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, in pinned memory when it lies on a card: a
    camera's frames arrive in host memory."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    out.copy_(t)
    return out


def free_device(device) -> None:
    """Return what the program held to the device (after the window)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def state_bytes(states) -> int:
    """Bytes of device memory the given states (the check's copies) hold."""
    return sum(t.numel() * t.element_size() for st in states
               for t in list(st.map) + list(st[1:]))


def program_peak(device, before: int, held: int) -> int:
    """The program's peak device memory, the check's copies left out: the
    larger of the peak before they were made (``before``) and the peak
    since, less the ``held`` bytes they took (made once, kept to the
    end)."""
    return max(before, peak_bytes(device) - held)

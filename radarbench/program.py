"""What the drivers share: the program's configuration from a config file,
the control's lower-precision paths, the reservoir that samples outputs
for the comparison, and the device line."""

from __future__ import annotations

import copy
import random

import numpy as np


def variant_config(cfg: dict, variant: str) -> dict:
    """The configuration the program runs: ``cfg`` itself, or for the
    control ``cfg`` with its "control" section's algorithm overrides and
    impls applied. The reference always gets ``cfg``."""
    if variant == "program":
        return cfg
    if variant != "control":
        raise ValueError(f"unknown variant {variant!r}")
    out = copy.deepcopy(cfg)
    ctl = cfg["control"]
    out["algorithm"].update(ctl.get("algorithm", {}))
    for key in ("impl", "chain_impl"):
        if key in ctl:
            out[key] = ctl[key]
    return out


def host_threads(cfg: dict) -> None:
    """Set torch's intra-op threads on the host to the configuration's
    ``host_threads`` (a deployment setting; the rest of the host's cores
    stay free)."""
    import torch

    if "host_threads" in cfg:
        torch.set_num_threads(int(cfg["host_threads"]))


def radar_config(cfg: dict):
    """The port's RadarConfig of a configuration's device and algorithm."""
    from fmcw_radar_processing_tpu_torch.config import RadarConfig
    from fmcw_radar_processing_tpu_torch.config.radar import AlgorithmConfig, DeviceConfig

    return RadarConfig.create(DeviceConfig(**cfg["device"]),
                              AlgorithmConfig(**cfg["algorithm"]))


def lower_outputs(out: dict, cfg: dict, variant: str) -> dict:
    """The control's stores one step below the configuration's where the
    program has no such path of its own: each output named in "control"
    "round_outputs" rounded to the dtype given there."""
    if variant != "control":
        return out
    import torch

    for name, dtype in cfg["control"].get("round_outputs", {}).items():
        if out.get(name) is not None:
            t = torch.as_tensor(np.asarray(out[name], np.float32))
            out[name] = t.to(getattr(torch, dtype)).to(torch.float32).numpy()
    return out


class Reservoir:
    """A uniform sample of ``k`` items from a stream of unknown length,
    drawn from ``seed``: item i replaces a kept one with probability
    k/(i+1)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n = k, random.Random(seed), 0
        self.items: dict[int, object] = {}

    def offer(self, make) -> None:
        """Offer item number ``self.n``; ``make()`` builds what is kept."""
        i = self.n
        self.n += 1
        if len(self.items) < self.k:
            self.items[i] = make()
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            del self.items[sorted(self.items)[j]]
            self.items[i] = make()


def device_info(device, count: int) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count}


def memory_peak(device) -> int:
    import torch

    dev = torch.device(device)
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

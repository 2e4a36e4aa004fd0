"""Small copies of the configurations, and the port's tree on them."""

import numpy as np

from bench import harness, reference, spec


def config(name: str, n_cases: int) -> dict:
    cfg = spec.config(name)
    cfg["n_cases"] = n_cases
    return cfg


def data(name: str, n_cases: int, seed: int, device="cpu"):
    cfg = config(name, n_cases)
    return cfg, spec.generator(cfg["generator"]).generate(cfg, seed, device)


def port_tree(data, grow: dict, device="cpu") -> dict[str, np.ndarray]:
    build = harness.port_builder(grow, device)
    return harness.host_tree(build(harness.dataset(data)))


def oracle(data, grow: dict, tested=None, dtype=None):
    kw = {} if dtype is None else dict(dtype=dtype)
    return reference.grow(data.x, data.y, n_bins=data.n_bins,
                          attr_is_cont=data.attr_is_cont,
                          n_classes=data.n_classes,
                          grow=reference.Grow.of(grow), tested=tested, **kw)

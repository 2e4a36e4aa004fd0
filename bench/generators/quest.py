"""QUEST / Agrawal function 5 (SyD10M9A, the paper's Table 1), on the
device from the seed.

A torch rewrite, frozen for the benchmark, of
``src/repro_torch/data/quest.py`` at commit
fe76ba3c169015bc8474eaf345bd872003045a00 (itself the MOA
``AgrawalGenerator`` formulation of Agrawal et al., VLDB'92): the same
attribute model, function 5's labels and the label flips, drawn by a
``torch.Generator`` on the device in float64.  It repeats for a seed on one
device and torch version; it does not repeat the numpy stream of the
original.

The configuration file gives ``function`` (5 only), ``perturbation`` (the
share of labels flipped), ``max_bins`` and ``n_cases``.
"""

from __future__ import annotations

import torch

from bench.binning import bin_continuous, bin_discrete
from bench.dataset import Data, stack

ATTRS = (("salary", True), ("commission", True), ("age", True),
         ("hvalue", True), ("hyears", True), ("loan", True),
         ("elevel", False), ("car", False), ("zipcode", False))


def _between(v, lo, hi):
    return (lo <= v) & (v <= hi)


def generate(config: dict, seed: int, device) -> Data:
    if config.get("function", 5) != 5:
        raise ValueError("only QUEST function 5 is implemented")
    n = int(config["n_cases"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(generator=g, device=device, dtype=torch.float64)

    def uniform(lo, hi):
        return torch.rand(n, **f64) * (hi - lo) + lo

    def codes(k):
        return torch.randint(0, k, (n,), generator=g, device=device)

    salary = uniform(20_000, 150_000)
    commission = torch.where(salary >= 75_000, 0.0,
                             uniform(10_000, 75_000))
    age = uniform(20, 80)
    elevel, car, zipcode = codes(5), codes(20), codes(9)
    hvalue = uniform(50_000, 150_000) * (zipcode + 1) * 0.5
    hyears = uniform(1, 30)
    loan = uniform(0, 500_000)

    young, middle = age < 40, (age >= 40) & (age < 60)
    group_a = torch.where(
        young, _between(salary, 50_000, 100_000)
        & _between(loan, 100_000, 300_000),
        torch.where(middle, _between(salary, 75_000, 125_000)
                    & _between(loan, 200_000, 400_000),
                    _between(salary, 25_000, 75_000)
                    & _between(loan, 300_000, 500_000)))
    y = torch.where(group_a, 0, 1)
    flip = torch.rand(n, **f64) < float(config["perturbation"])
    y = torch.where(flip, 1 - y, y)

    raw = dict(salary=salary, commission=commission, age=age,
               hvalue=hvalue, hyears=hyears, loan=loan, elevel=elevel,
               car=car, zipcode=zipcode)
    max_bins = int(config["max_bins"])
    columns = [bin_continuous(raw[name], max_bins) if cont
               else bin_discrete(raw[name]) for name, cont in ATTRS]
    return stack(columns, y, attr_is_cont=[c for _, c in ATTRS],
                 n_classes=2, attr_names=[name for name, _ in ATTRS])

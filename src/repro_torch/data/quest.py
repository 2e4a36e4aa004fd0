"""QUEST/Agrawal synthetic classification generator (paper Sect. 5).

The paper's largest dataset, *SyD10M9A*, is "synthetically generated using
function 5 of the QUEST data generator" — the classic Agrawal et al.
generator (An Interval Classifier for Database Mining Applications, VLDB'92)
with 9 predictive attributes (6 continuous, 3 discrete) and 2 classes,
exactly Table 1's schema.

We implement the attribute model and classification functions 1–5 following
the widely-used MOA ``AgrawalGenerator`` formulation (the original IBM QUEST
code is no longer distributed).  Function 5 labels by age-banded salary and
loan intervals.

Attributes (order matters — it is Table 1's 6 continuous + 3 discrete):

  salary      continuous  U[20k, 150k]
  commission  continuous  0 if salary >= 75k else U[10k, 75k]
  age         continuous  U[20, 80]
  hvalue      continuous  U[50k, 150k] * zipcode-dependent factor
  hyears      continuous  U[1, 30]
  loan        continuous  U[0, 500k]
  elevel      discrete    {0..4}
  car         discrete    {0..19}
  zipcode     discrete    {0..8}
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.binning import BinnedDataset, fit

ATTR_NAMES = ("salary", "commission", "age", "hvalue", "hyears", "loan",
              "elevel", "car", "zipcode")
ATTR_IS_CONT = (True, True, True, True, True, True, False, False, False)


def _raw_attributes(n: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
    salary = rng.uniform(20_000, 150_000, n)
    commission = np.where(salary >= 75_000, 0.0, rng.uniform(10_000, 75_000, n))
    age = rng.uniform(20, 80, n)
    elevel = rng.integers(0, 5, n)
    car = rng.integers(0, 20, n)
    zipcode = rng.integers(0, 9, n)
    hvalue = rng.uniform(50_000, 150_000, n) * (zipcode + 1) * 0.5
    hyears = rng.uniform(1, 30, n)
    loan = rng.uniform(0, 500_000, n)
    return dict(salary=salary, commission=commission, age=age, hvalue=hvalue,
                hyears=hyears, loan=loan, elevel=elevel, car=car,
                zipcode=zipcode)


def _classify(fn: int, a: dict[str, np.ndarray]) -> np.ndarray:
    """Group A = class 0, Group B = class 1 (MOA functions 1-5)."""
    age, salary, loan, elevel = a["age"], a["salary"], a["loan"], a["elevel"]
    if fn == 1:
        group_a = (age < 40) | (age >= 60)
    elif fn == 2:
        group_a = np.select(
            [age < 40, age < 60],
            [(50_000 <= salary) & (salary <= 100_000),
             (75_000 <= salary) & (salary <= 125_000)],
            (25_000 <= salary) & (salary <= 75_000))
    elif fn == 3:
        group_a = np.select(
            [age < 40, age < 60],
            [np.isin(elevel, (0, 1)), np.isin(elevel, (1, 2, 3))],
            np.isin(elevel, (2, 3, 4)))
    elif fn == 4:
        group_a = np.select(
            [age < 40, age < 60],
            [np.where(np.isin(elevel, (0, 1)),
                      (25_000 <= salary) & (salary <= 75_000),
                      (50_000 <= salary) & (salary <= 100_000)),
             np.where(np.isin(elevel, (1, 2, 3)),
                      (50_000 <= salary) & (salary <= 100_000),
                      (75_000 <= salary) & (salary <= 125_000))],
            np.where(np.isin(elevel, (2, 3, 4)),
                     (50_000 <= salary) & (salary <= 100_000),
                     (25_000 <= salary) & (salary <= 75_000)))
    elif fn == 5:
        group_a = np.select(
            [age < 40, age < 60],
            [(50_000 <= salary) & (salary <= 100_000)
             & (100_000 <= loan) & (loan <= 300_000),
             (75_000 <= salary) & (salary <= 125_000)
             & (200_000 <= loan) & (loan <= 400_000)],
            (25_000 <= salary) & (salary <= 75_000)
            & (300_000 <= loan) & (loan <= 500_000))
    else:
        raise ValueError(f"function {fn} not implemented (1..5)")
    return np.where(group_a, 0, 1).astype(np.int32)


def generate(n: int, *, function: int = 5, seed: int = 0,
             perturbation: float = 0.05, max_bins: int = 256,
             ) -> BinnedDataset:
    """Generate an Agrawal/QUEST dataset in rank space.

    ``perturbation`` is QUEST's label-noise knob: that fraction of labels is
    flipped uniformly (keeps induced trees realistic rather than exact).
    """
    rng = np.random.default_rng(seed)
    attrs = _raw_attributes(n, rng)
    y = _classify(function, attrs)
    if perturbation > 0:
        flip = rng.random(n) < perturbation
        y = np.where(flip, 1 - y, y)
    columns = [attrs[name] for name in ATTR_NAMES]
    return fit(columns, y, attr_is_cont=ATTR_IS_CONT, n_classes=2,
               max_bins=max_bins, attr_names=ATTR_NAMES)


def syd(n: int = 10_000_000, *, seed: int = 0, max_bins: int = 256,
        ) -> BinnedDataset:
    """SyD10M9A (paper Table 1) — pass a smaller ``n`` for scaled runs."""
    return generate(n, function=5, seed=seed, max_bins=max_bins)

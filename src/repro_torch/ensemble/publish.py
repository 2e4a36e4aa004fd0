"""Bridge trained forests into the serving stack (pack -> atomic publish).

The training loop's last mile, as the JAX package's ``ensemble.publish``:
pack the ordered trees with :func:`repro_torch.infer.forest.Forest.pack`
and publish them atomically through :func:`repro_torch.infer.registry.publish`,
stamping the manifest with everything needed to reproduce or audit the
model (seed, mtry, bootstrap, grow criterion, OOB score).  From there the
standard serving flow applies unchanged — ``ModelHandle`` pins the version,
``set_canary`` routes a uid fraction onto a candidate, ``promote_canary`` /
``rollback`` move the fleet.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.binning import BinnedDataset
from repro_torch.core.device import resolve_device
from repro_torch.ensemble import oob as oob_mod
from repro_torch.ensemble.trainer import ForestConfig, TrainResult
from repro_torch.infer import registry
from repro_torch.infer.forest import Forest


def forest_metadata(fc: ForestConfig, *, n_attrs: int,
                    oob: oob_mod.OOBResult | None = None,
                    extra: dict | None = None) -> dict[str, Any]:
    """The manifest metadata block for a published forest."""
    meta: dict[str, Any] = {
        "kind": "random_forest",
        "seed": fc.seed,
        "n_trees": fc.n_trees,
        "mtry": fc.resolved_mtry(n_attrs),
        "bootstrap": fc.bootstrap,
        "criterion": fc.grow.criterion,
        "min_objs": fc.grow.min_objs,
        "max_depth": fc.grow.max_depth,
    }
    if oob is not None:
        meta["oob_score"] = oob.score
        meta["oob_coverage"] = oob.coverage
    if extra:
        meta.update(extra)
    return meta


def publish_forest(root: str, name: str, result: TrainResult,
                   ds: BinnedDataset, *, score_oob: bool = True,
                   weights=None, metadata: dict | None = None,
                   keep_last: int | None = None, device=None) -> str:
    """Pack + atomically publish a training run; returns the version path.

    ``score_oob=True`` (default, bootstrap runs only) computes the OOB
    estimate on ``device`` (None: the card; raises without one) and records
    it in the manifest — the number a canary / promotion decision reads
    back via ``registry.manifest_of``.  ``keep_last`` forwards to the
    registry's retention GC.
    """
    dev = resolve_device(device)
    oob = None
    if score_oob and result.config.bootstrap:
        oob = oob_mod.oob_score(result.trees, ds, result.config,
                                tree_ids=result.tree_ids, device=dev)
    meta = forest_metadata(result.config, n_attrs=ds.n_attrs, oob=oob,
                           extra=metadata)
    meta["tree_ids"] = result.tree_ids
    meta["quarantined"] = result.quarantined
    forest = Forest.pack(result.trees, weights=weights, device=dev)
    return registry.publish(root, name, forest, metadata=meta,
                            keep_last=keep_last)

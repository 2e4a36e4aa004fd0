"""The control: the reference put in the program's place and computed in
bfloat16, the precision below the float32 the configurations state, has to
come out as not correct; the float32 port, at the same sizes, as correct.

On the card at each cell's own size ``bench/calibrate.py`` reads both over
many seeds; here at a size a test run holds."""

import pytest
import torch

from bench import reference
from bench.tests import _small

# each cell's growth: syd10m9a.deep's, and syd10m9a.shallow's depth 6
CASES = [("syd10m9a", 20000, {}), ("syd10m9a", 20000, {"max_depth": 6})]


@pytest.mark.parametrize("name,n,over", CASES)
@pytest.mark.parametrize("seed", (11, 12, 2**31 + 13))
def test_control_fails_and_the_port_passes(name, n, over, seed):
    cfg, d = _small.data(name, n, seed)
    grow = {**cfg["grow"], **over}
    control = _small.oracle(d, grow, dtype=torch.bfloat16).tree
    judged = _small.oracle(d, grow, tested=control)
    assert reference.compare(control, judged.tree) > 0
    port = _small.port_tree(d, grow)
    judged = _small.oracle(d, grow, tested=port)
    assert reference.compare(port, judged.tree) == 0

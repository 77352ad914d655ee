"""The port's SetCriterion in `grid` mode (the JAX default) against the JAX
package's, with and without the DN block, with importance 1.0 and 0.75
(tests/test_torch_criterion.py holds the other modes and cases, and says how
the draws are recorded and replayed; its tolerance: 2e-5 relative, 1e-6
absolute). Six tests at most a file: the Tier-1 run queues such files behind
its longest one (ROADMAP.md, "Tier-1's clock").
"""

import numpy as np
import pytest

from test_torch_criterion import _assignments, _criteria, _outputs, _run_both, _targets


@pytest.mark.parametrize("importance", [1.0, 0.75])
@pytest.mark.parametrize("with_dn", [False, True])
def test_grid_mode_losses_match_jax(monkeypatch, with_dn, importance):
    """`grid` mode (the JAX default): with importance 1.0 no draw is needed,
    with 0.75 the Bernoulli extras are the recorded ones. Invalid slots in
    both images; DN with scalar 2 over all slots."""
    b, q, n, h, w, layers = 2, 10, 5, 16, 16, 3
    rng = np.random.RandomState(3)
    jt, tt = _targets(rng, b, n, 64, [[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]])
    meta = {"pad_size": 2 * n, "max_num": n, "scalar": 2}
    outputs = _outputs(rng, b, q, h, w, layers, 2 * n if with_dn else 0, meta)
    jc, tc = _criteria("grid", 512, 128, importance)
    got = _run_both(monkeypatch, jc, tc, outputs, jt, tt, _assignments(rng, layers, b, q, n))
    assert len(got) == 6 * layers
    if not with_dn:
        assert all(got[k].item() == 0.0 for k in got if "_dn" in k)

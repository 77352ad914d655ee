"""The port's MaskDN decoder against the JAX decoder in the DN modes `points`,
`lb` and `mask`, each with and without HEAD_DN
(tests/test_torch_dn_modes.py:check_decoder_outputs, its sizes, draws and
tolerances). Six tests at most a file: the Tier-1 run queues such files
behind its longest one (ROADMAP.md, "Tier-1's clock").
"""

import pytest

from test_torch_dn_modes import DECODER_GROUPS, check_decoder_outputs


@pytest.mark.parametrize("mode,head_dn", DECODER_GROUPS["outputs"])
def test_decoder_outputs_match_jax(monkeypatch, mode, head_dn):
    check_decoder_outputs(monkeypatch, mode, head_dn)

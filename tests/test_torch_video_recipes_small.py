"""The YouTube-VIS 2019 and 2021 recipes of R50, R101 and Swin-T built in the port
with the JAX model's parameter shapes (`tests/test_torch_video.py:
check_recipe_shapes`), grouped by backbone so that each architecture is
traced once. Six tests at most a file: the Tier-1 run queues such files
behind its longest one (ROADMAP.md, "Tier-1's clock")."""

import pytest

from test_torch_video import RECIPES, check_recipe_shapes

BACKBONES = ("R50", "R101", "swin_tiny")
GROUP = [rel for rel in RECIPES if any(f"_{b}_" in rel for b in BACKBONES)]


@pytest.mark.parametrize("rel", GROUP)
def test_video_recipe_builds_with_the_jax_shapes(rel):
    assert len(GROUP) == 6
    check_recipe_shapes(rel)

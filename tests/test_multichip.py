"""The multi-device dry run (__graft_entry__.dryrun_multichip) on the
virtual CPU mesh conftest.py sets up: the same assertions chip_smoke.py
--gpus 4 makes on four GPUs, at a reduced operating point."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("n_map", [None, 40])
def test_dryrun_multichip_cpu_mesh(n_map):
    import jax

    from __graft_entry__ import dryrun_multichip

    assert jax.devices()[0].platform == "cpu" and len(jax.devices()) >= 4
    out = dryrun_multichip(4, n_map=n_map)
    assert out["sharded_matches_single"]
    assert out["store_rows"] == (n_map or 8)
    assert out["mesh_sizes"] == ([4] if n_map else [4, 2])
    assert out["hints"] > 0 and out["pass1"] > 0

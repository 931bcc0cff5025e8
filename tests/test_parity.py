"""utils/parity.py: the tolerances the fused frame is held to."""

import numpy as np

from kylespathtracer.utils import parity


def _planes(rng, h=40, w=50):
    return {
        "rgb": rng.uniform(0, 2, (h, w, 3)),
        "depth": rng.uniform(1, 10, (h, w)),
        "oid": rng.integers(0, 5, (h, w)),
    }


def test_rounding_passes_flips_are_counted():
    rng = np.random.default_rng(0)
    ref = _planes(rng)
    got = {k: v.copy() for k, v in ref.items()}
    got["rgb"] = got["rgb"] * (1 + 1e-6)  # rounding-level differences
    r = parity.compare(got, ref)
    assert r["ok"] and r["flip_frac"] == 0.0 and r["oid_equal"] == 1.0
    got["rgb"][3, 4, 1] += 0.5  # one decision-boundary flip of 2000 px
    got["rgb"][5, 5, 0] += 5e-4  # two steep near-boundary pixels
    got["rgb"][6, 6, 2] -= 5e-4
    r = parity.compare(got, ref, mask=np.zeros((40, 50), bool))
    assert r["flip_frac"] == 1 / 2000 and r["outlier_frac"] == 3 / 2000
    assert r["flips_on_boundary"] == 0.0
    assert not r["ok"]  # 0.1% outliers at most under SINGLE
    assert parity.compare(got, ref, parity.TEMPORAL)["ok"]


def test_failures_and_boundary_classification():
    rng = np.random.default_rng(1)
    ref = _planes(rng)
    many = {k: v.copy() for k, v in ref.items()}
    many["rgb"][:2] += 1.0  # 5% of the pixels flip
    assert not parity.compare(many, ref, parity.TEMPORAL)["ok"]
    nan = {k: v.copy() for k, v in ref.items()}
    nan["rgb"][0, 0, 0] = np.nan
    assert parity.compare(nan, ref)["flip_frac"] > 0
    oid = {k: v.copy() for k, v in ref.items()}
    oid["oid"] = oid["oid"] + 1
    assert not parity.compare(oid, ref)["ok"]
    # Flips off the boundary mask fail the TEMPORAL interior check.
    few = {k: v.copy() for k, v in ref.items()}
    few["rgb"][10, 10] += 1.0
    edge = np.zeros((40, 50), bool)
    edge[10, 10] = True
    assert parity.compare(few, ref, parity.TEMPORAL, edge)["ok"]
    assert not parity.compare(few, ref, parity.TEMPORAL, ~edge)["ok"]
    mask = parity.boundary_mask([ref["oid"]], [np.zeros((40, 50, 3))])
    assert mask.shape == (40, 50) and mask.any()


def test_id_edges_mark_silhouettes():
    oid = np.zeros((9, 9), int)
    oid[3:6, 3:6] = 2  # a 3x3 object on the background
    edge = parity.id_edges(oid)
    # Both sides of the object's outline, not its centre or the far field.
    assert edge[3, 3] and edge[2, 4] and not edge[4, 4] and not edge[0, 0]
    assert edge.sum() == 9 - 1 + 12
    wide = parity.id_edges(oid, dilate=1)
    assert wide[4, 4] and wide[1, 4] and not wide[0, 0]

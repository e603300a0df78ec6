"""The port's measurement tools on the CPU: the SASS loop counter and the
replay of the kNN kernel's top-k scheme."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import knn_topk_sim  # noqa: E402
import sass_loops  # noqa: E402

SASS = """
        Function : _Z3fooPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x0 */
        /*0010*/                   FMUL R2, R3, R4 ;             /* 0x0 */
        /*0020*/                   LDS.128 R4, [R2] ;            /* 0x0 */
        /*0030*/                   FADD R2, R2, R5 ;             /* 0x0 */
        /*0040*/                   VOTE.ANY R6, PT, P0 ;         /* 0x0 */
        /*0050*/              @!P0 BRA 0x10 ;                    /* 0x0 */
        /*0060*/                   EXIT ;                        /* 0x0 */
        Function : _Z3barPf
        /*0000*/                   BRA 0x0 ;                     /* 0x0 */
"""


def test_sass_loops_finds_the_loop_and_counts_its_classes():
    funcs = sass_loops.parse(SASS)
    assert list(funcs) == ["_Z3fooPf", "_Z3barPf"]
    foo = funcs["_Z3fooPf"]
    assert sass_loops.loops(foo) == [(0x10, 0x50)]
    body = [i for i in foo if 0x10 <= i[0] <= 0x50]
    assert sass_loops.classify(body) == {"total": 5, "branch": 1, "fp32": 2, "shared": 1,
                                         "warp": 1}
    assert sass_loops.loops(funcs["_Z3barPf"]) == [(0, 0)]


def test_top_k_replay_counts_at_least_k_candidates_and_a_merge_per_buffer():
    pts = np.random.default_rng(0).normal(size=(2048, 4))
    out = knn_topk_sim.simulate(pts, k=64, rows=4)
    # every row takes its first k points, and a merge empties at most 32
    assert out["candidates"] >= 64
    assert out["merges"] >= (out["candidates"] - 32) / 32
    assert 0 < out["mean_fill"] <= 32
    assert out["hit_steps"] <= 2048 / 32
    # the random-order estimate is close for a normal cloud
    assert 0.7 < out["candidates"] / out["k_1_plus_ln_n_over_k"] < 1.5

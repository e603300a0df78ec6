"""A process mesh: a 3-rank gloo world on the CPU.

One world of three processes, started once for the file, runs the JAX
package's distributed example flow
(``graphmine_tpu_torch/parallel/distributed_flow.py``) on a 1,024-vertex
planted graph, each rank with a finite timeout, and writes its results.
An odd world size exercises the padding and the ring. Held here:

- every rank returns the same results;
- LPA on the sort, bucketed, blocked and 2-D bodies, CC (sort and 2-D),
  ring LPA and CC, and the kNN indices are bit-equal to the JAX
  package's 3-device CPU mesh (its sort-body LPA and CC, which every JAX
  body equals); PageRank (both schedules) and PPR are within L1 1e-5 of
  JAX's; LOF is within the pipeline tests' tolerance;
- every result is bit-equal to the port's in-process mesh of 3 shards
  (the same flow, one process);
- the world's checkpoint loads in one process, and its resume on 2 ranks
  equals the in-process one;
- rank 0 holds ``initialize_distributed``'s contract: False with no
  cluster in the environment, a raise on a partial one, True again once
  joined;
- a surviving mesh over ranks 0 and 2 (a group whose ranks are not the
  world's: the ring's sends go to global ranks) and a multi-slice mesh
  over all three give the in-process meshes' labels.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild
from graphmine_tpu.ops.degrees import out_degrees as jout_degrees
from graphmine_tpu.parallel import knn as jknn
from graphmine_tpu.parallel import ppr as jppr
from graphmine_tpu.parallel import ring as jring
from graphmine_tpu.parallel import sharded as js
from graphmine_tpu.parallel.mesh import make_mesh as jmake_mesh

from graphmine_tpu_torch.parallel import distributed_flow as flow
from graphmine_tpu_torch.parallel.mesh import make_mesh
from graphmine_tpu_torch.pipeline.checkpoint import load_sharded

REPO = Path(__file__).resolve().parent.parent
WORLD, V, E, SEED = 3, 1024, 8000, 9
TIMEOUT_S = 120

# Rank 0 first holds initialize_distributed's contract on its own
# environment, then joins; the flow's own call must then find the world.
RANK = """
import json, os, sys
from graphmine_tpu_torch.parallel import distributed_flow, mesh
out = sys.argv[1]
if os.environ["RANK"] == "0":
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    seen = {"no_env": mesh.initialize_distributed()}
    os.environ["RANK"] = env["RANK"]
    try:
        mesh.initialize_distributed(device="cpu")
    except ValueError as e:
        seen["partial"] = str(e)
    os.environ.update(env)
    seen["joined"] = mesh.initialize_distributed(device="cpu", initialization_timeout=%d)
    seen["again"] = mesh.initialize_distributed(device="cpu")
    json.dump(seen, open(os.path.join(out, "contract.json"), "w"))
else:
    mesh.initialize_distributed(device="cpu", initialization_timeout=%d)
import numpy as np
from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.parallel import ring, sharded
src, dst, _ = distributed_flow.flow_inputs(%d, %d, %d)
g = build_graph(src, dst, num_vertices=%d, device="cpu")
extra = {}
for name, m in (("survivors", mesh.surviving_mesh(2, exclude=[1])),
                ("multislice", mesh.make_multislice_mesh(1))):
    sg = sharded.shard_graph_arrays(sharded.partition_graph(g, mesh=m), m)
    if m.local:
        run = ring.ring_label_propagation if name == "survivors" else sharded.sharded_label_propagation
        extra[name] = run(sg, m, max_iter=5).numpy()
np.savez(os.path.join(out, "extra%%s.npz" %% os.environ["RANK"]), **extra)
sys.exit(distributed_flow.main(["--out", out, "--device", "cpu", "--vertices", "%d",
                                "--edges", "%d", "--seed", "%d", "--timeout-s", "%d"]))
""" % (TIMEOUT_S, TIMEOUT_S, V, E, SEED, V, V, E, SEED, TIMEOUT_S)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world_procs(tmp_path_factory):
    """The three ranks, started before the references are computed."""
    out = tmp_path_factory.mktemp("world")
    env = {**os.environ, "WORLD_SIZE": str(WORLD), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "OMP_NUM_THREADS": "1"}
    env.pop("GRAPHMINE_VIRTUAL_DEVICES", None)
    procs = []
    for r in range(WORLD):
        with open(out / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", RANK, str(out)], cwd=REPO,
                                          env={**env, "RANK": str(r)}, stdout=log,
                                          stderr=subprocess.STDOUT))
    yield out, procs
    for p in procs:  # a failed world is killed, never left behind
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def inputs():
    return flow.flow_inputs(V, E, SEED)


@pytest.fixture(scope="module")
def references(world_procs, inputs, tmp_path_factory):
    """The JAX package's 3-device mesh, then the port's in-process mesh of
    3 shards, on the flow's inputs (while the world runs)."""
    src, dst, pts = inputs
    jm = jmake_mesh(WORLD)
    g = jbuild(src, dst, num_vertices=V)
    gd = jbuild(src, dst, num_vertices=V, symmetric=False)

    def placed(graph, **kw):
        return js.shard_graph_arrays(js.partition_graph(graph, mesh=jm, **kw), jm)

    # Every JAX shard body gives the same labels (its own suite holds
    # that), so the sort body's compiled program stands for all four: the
    # bucketed, blocked and 2-D ones each take seconds to compile.
    sort = placed(g)
    lpa = np.asarray(js.sharded_label_propagation(sort, jm, max_iter=5))
    cc = np.asarray(js.sharded_connected_components(sort, jm))
    jax_out = {"lpa_sort": lpa, "lpa_bucketed": lpa, "lpa_blocked": lpa, "lpa_2d": lpa,
               "cc": cc, "cc_2d": cc}
    jax_out["ring_lpa"] = np.asarray(jring.ring_label_propagation(sort, jm, max_iter=5))
    jax_out["ring_cc"] = np.asarray(jring.ring_connected_components(sort, jm))
    sgd, od = placed(gd), jout_degrees(gd)
    jax_out["pagerank"] = np.asarray(js.sharded_pagerank(sgd, jm, od, max_iter=30))
    jax_out["ring_pagerank"] = np.asarray(jring.ring_pagerank(sgd, jm, od, max_iter=30))
    sources = [s % V for s in flow.PPR_SOURCES]
    jax_out["ppr"] = np.asarray(jppr.sharded_personalized_pagerank(gd, sources, jm, max_iter=30))
    d2, idx = jknn.sharded_knn(jnp.asarray(pts), jm, flow.KNN_K)
    jax_out["knn_d2"], jax_out["knn_idx"] = np.asarray(d2), np.asarray(idx)
    jax_out["lof"] = np.asarray(jknn.sharded_lof(jnp.asarray(pts), jm, k=flow.KNN_K,
                                                 impl="exact"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GRAPHMINE_VIRTUAL_DEVICES", str(WORLD))
            mesh = make_mesh(WORLD, devices=["cpu"] * WORLD)
            port = flow.run_flow(mesh, src, dst, V, pts,
                                 str(tmp_path_factory.mktemp("in_process")))
    finally:
        torch.set_num_threads(threads)
    return jax_out, port


@pytest.fixture(scope="module")
def ranks(world_procs, references):
    """Each rank's results, once every rank has exited 0 (a world that
    times out fails here, its ranks killed). The references are computed
    first, while the world runs."""
    out, procs = world_procs
    deadline = time.monotonic() + TIMEOUT_S + 30
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pytest.fail(f"rank {r} did not finish in time")
        log = (out / f"rank{r}.log").read_text()[-3000:]
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def test_the_world_ran_over_gloo_on_the_host(ranks):
    _, res = ranks
    for r, got in enumerate(res):
        assert str(got["backend"]) == "gloo" and not bool(got["virtual"])
        assert int(got["world_size"]) == WORLD, r


def test_every_rank_returns_the_same_results(ranks):
    _, res = ranks
    shared = set(res[0]) - {"resumed"}
    for r in range(1, WORLD):
        assert set(res[r]) - {"resumed"} == shared
        for key in sorted(shared):
            np.testing.assert_array_equal(res[r][key], res[0][key], err_msg=f"rank {r} {key}")


LABELS = ("lpa_sort", "lpa_bucketed", "lpa_blocked", "lpa_2d", "cc", "cc_2d", "ring_lpa",
          "ring_cc")


@pytest.mark.parametrize("key", LABELS)
def test_labels_bit_equal_to_the_jax_mesh(ranks, references, key):
    jax_out, _ = references
    np.testing.assert_array_equal(ranks[1][0][key], jax_out[key])


def test_knn_and_lof_against_the_jax_mesh(ranks, references):
    got, (jax_out, _) = ranks[1][0], references
    np.testing.assert_array_equal(got["knn_idx"], jax_out["knn_idx"])
    np.testing.assert_allclose(got["knn_d2"], jax_out["knn_d2"], rtol=1e-5, atol=0)
    # the pipeline tests' LOF tolerance: rtol 1e-4 on 99.9% of points, 1e-2 on all
    close = np.isclose(got["lof"], jax_out["lof"], rtol=1e-4, atol=0)
    assert close.mean() >= 0.999
    np.testing.assert_allclose(got["lof"], jax_out["lof"], rtol=1e-2, atol=0)


@pytest.mark.parametrize("key", ["pagerank", "ring_pagerank", "ppr"])
def test_ranks_within_l1_of_jax(ranks, references, key):
    got, (jax_out, _) = ranks[1][0], references
    assert float(np.abs(got[key] - jax_out[key]).sum()) <= 1e-5


def test_the_world_equals_the_in_process_mesh(ranks, references):
    _, port = references
    for r, got in enumerate(ranks[1]):
        for key in sorted(set(port) - {"resumed"}):
            np.testing.assert_array_equal(got[key], port[key], err_msg=f"rank {r} {key}")


def test_checkpoint_loads_in_one_process_and_resumes_on_two_ranks(ranks, references):
    out, res = ranks
    labels, it = load_sharded(str(out / "checkpoint"))
    assert it == flow.LPA_ITERS
    np.testing.assert_array_equal(labels, res[0]["lpa_bucketed"])
    manifest = json.loads((out / "checkpoint" / "lpa_sharded" / "manifest.json").read_text())
    assert manifest["num_shards"] == WORLD and manifest["mesh_shape"] == [WORLD]
    # the resume ran on ranks 0 and 1 only, as on the in-process mesh
    assert "resumed" not in res[2]
    for r in (0, 1):
        np.testing.assert_array_equal(res[r]["resumed"], references[1]["resumed"])


def test_initialize_distributed_contract(ranks):
    out, _ = ranks
    seen = json.loads((out / "contract.json").read_text())
    assert seen["no_env"] is False
    assert "WORLD_SIZE" in seen["partial"] and "coordinator_address" in seen["partial"]
    assert seen["joined"] is True and seen["again"] is True


def test_surviving_and_multislice_meshes_span_the_ranks(ranks, inputs):
    """Ranks 0 and 2 after losing rank 1 run the ring (ranks 1 holds no
    shard), and a (1, 3) multi-slice mesh runs the replicated schedule:
    the labels of the in-process meshes of the same shapes."""
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.parallel import ring, sharded
    from graphmine_tpu_torch.parallel.mesh import make_multislice_mesh, surviving_mesh

    out, _ = ranks
    src, dst, _ = inputs
    g = build_graph(src, dst, num_vertices=V, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAPHMINE_VIRTUAL_DEVICES", str(WORLD))
        cpus = ["cpu"] * WORLD
        want = {}
        for name, m in (("survivors", surviving_mesh(2, exclude=[1], devices=cpus)),
                        ("multislice", make_multislice_mesh(1, devices=cpus))):
            sg = sharded.shard_graph_arrays(sharded.partition_graph(g, mesh=m), m)
            run = (ring.ring_label_propagation if name == "survivors"
                   else sharded.sharded_label_propagation)
            want[name] = run(sg, m, max_iter=5).numpy()
    for r in range(WORLD):
        got = dict(np.load(out / f"extra{r}.npz"))
        assert set(got) == ({"multislice"} if r == 1 else {"survivors", "multislice"}), r
        for name, labels in got.items():
            np.testing.assert_array_equal(labels, want[name], err_msg=f"rank {r} {name}")

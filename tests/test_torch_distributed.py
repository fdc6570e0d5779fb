"""paml_tpu_torch on two processes (`parallel/distributed.py`) on the CPU:
two gloo ranks, each started with a port from `bind(0)` and waited for
with a timeout of its own, cut the pattern axis of the codon objective
between them; each rank's value and gradient equal one process's (clean
state codes and `TipCodes`).  Then `torchrun --nproc_per_node 2 -m
paml_tpu_torch codeml ... --device cpu`: rank 0 alone writes mlc and
prints, with one process's lnL."""
import os
import re
import socket
import subprocess
import sys

import numpy as np

from paml_tpu_torch import __main__ as cli
from paml_tpu_torch.parallel import distributed
from test_torch_cli import write_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")

WORKER = r'''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, port, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from paml_tpu_torch.apps import codeml
from paml_tpu_torch.core import pruning
from paml_tpu_torch.core.topology import from_treenode
from paml_tpu_torch.io import seqio, treeio
from paml_tpu_torch.parallel import distributed
assert distributed.initialize(backend="gloo",
                              init_method=f"tcp://127.0.0.1:{port}",
                              world_size=2, rank=rank, device="cpu")
assert distributed.initialize()            # idempotent
aln = seqio.read_alignment(os.path.join(data, "clock56.codon"), 1)
rows = list(aln.rows)
rows[0] = "---" * 40 + rows[0][120:]
for clean in (True, False):
    d = seqio.pack(seqio.Alignment(aln.names, rows if not clean else
                                   list(aln.rows), 1), cleandata=clean)
    topo = from_treenode(treeio.read_trees(
        os.path.join(data, "clock56.trees"), d.names)[0], d.names)
    neg, _, _, x0, _, _ = codeml.make_codon_objective(
        d, topo, codeml.CodemlSpec(NSsites=2, cleandata=clean), device="cpu")
    def vg():
        x = torch.as_tensor(x0).requires_grad_(True)
        v = neg(x)
        return float(v.detach()), torch.autograd.grad(v, x)[0]
    v1, g1 = vg()
    mesh = distributed.global_data_mesh("cpu")
    pruning.set_pattern_mesh(mesh)
    v2, g2 = vg()
    pruning.set_pattern_mesh(None)
    dv = abs(v2 - v1) / abs(v1)
    dg = float((g2 - g1).abs().max() / g1.abs().max())
    lo, hi = mesh.rank_range(d.npatt)
    print(f"RANK {rank} {clean} {dv!r} {dg!r} {lo} {hi} {d.npatt} "
          f"{distributed.is_primary()}", flush=True)
torch.distributed.destroy_process_group()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        e.pop(k, None)
    return e


def test_two_gloo_ranks_match_one_process(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), port,
                               DATA], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env())
             for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    assert all(p.returncode == 0 for p in procs), outs
    lines = [ln.split() for o in outs for ln in o.splitlines()
             if ln.startswith("RANK")]
    assert len(lines) == 4
    spans = {}
    for _, rank, clean, dv, dg, lo, hi, H, primary in lines:
        assert float(dv) <= 1e-12 and float(dg) <= 1e-12, (dv, dg)
        assert (primary == "True") == (rank == "0")
        spans.setdefault(clean, []).append((int(lo), int(hi), int(H)))
    for rows in spans.values():
        (lo0, hi0, H), (lo1, hi1, _) = sorted(rows)
        assert lo0 == 0 and hi0 == lo1 and hi1 == H


def test_torchrun_codeml_one_writer(tmp_path, monkeypatch):
    import chip_smoke
    import torch

    rng = np.random.default_rng(11)
    names, rows, nwk, _ = chip_smoke.simulate_site_classes(
        torch, rng, 5, 80, "cpu", shape="trifurcating")
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    write_problem(one, names, rows, [nwk])
    write_problem(two, names, rows, [nwk])
    monkeypatch.chdir(one)
    want = cli.main(["codeml", "codeml.ctl", "--device", "cpu"])
    lnl = want["runs"][0]["res"].lnL
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(free_port()), "-m", "paml_tpu_torch",
         "codeml", "codeml.ctl", "--device", "cpu"], cwd=two, env=env(),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert p.stdout.count("results written to mlc") == 1
    text = open(os.path.join(two, "mlc")).read()
    got = [float(v) for v in re.findall(r"lnL\(ntime:.*\): *(-?[0-9.]+)",
                                        text)]
    assert len(got) == 1 and abs(got[0] - lnl) <= 1e-6
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))


def test_single_process_joins_nothing(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.is_primary()
    mesh = distributed.global_data_mesh("cpu")
    assert mesh.world == 1 and mesh.group is None and mesh.n_shards == 1
    assert distributed.default_backend("cpu") == "gloo"
    assert str(distributed.local_device("cpu")) == "cpu"

"""The mesh engine across processes: two ``torch.distributed`` processes
(gloo, CPU tensors), each owning one dp row of a 2x2 grid of CPU cells, run
the port's ``MeshAccumulator`` on ds200k. The cell totals, the histogram and
the per-cell outputs cross the process boundary; every process checks the
whole result against grom_tpu's host engines, as tests/multihost_worker.py
does for grom_tpu's mesh.

The worker is this file run as a script:
``python tests/test_torch_multihost.py <rank> <world> <port>``; it prints
MULTIHOST_OK on success."""

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_mesh():
    import pytest
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), "2", str(port)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("workers timed out:\n" + "\n".join(o or "" for o in outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (r, out[-4000:])
        assert "MULTIHOST_OK rank=%d" % r in out, out[-4000:]


def _worker(rank: int, world: int, port: str) -> None:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%s" % port,
                            world_size=world, rank=rank)
    try:
        from grom_tpu.call import scan as scan_mod
        from grom_tpu_torch.testing.fixtures import chrom_inputs
        from grom_tpu_torch.parallel.mesh import make_mesh
        from grom_tpu_torch.parallel.pipeline import (HIST_BINS,
                                                      MeshAccumulator)
        ci = chrom_inputs(os.path.join(HERE, "data", "ds200k"))
        # 2x2 grid, one dp row (two cells) per process
        mesh = make_mesh(world, 2, devices=["cpu", "cpu"])
        assert mesh.n_local == 2 and mesh.first_cell == 2 * rank
        acc = MeshAccumulator(mesh=mesh, seg_l=1 << 14)
        assert acc.coll == torch.device("cpu")
        base_tot, cand, (rd_mq, rd_hi, rd_lo), hist = acc.run(
            ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate)

        arr = scan_mod.accumulate_chromosome(ci.chrom, ci.batch, ci.cfg,
                                             ci.drv, ci.scan_start)
        base_host = (arr.snv.sum(axis=0)
                     + arr.snv_lowmq.sum(axis=0)).astype(np.int64)
        assert np.array_equal(base_tot, base_host), "base_tot"
        assert np.array_equal(rd_mq, arr.rd_mq), "rd_mq"
        assert np.array_equal(rd_hi, arr.rd_hi), "rd_hi"
        assert np.array_equal(rd_lo, arr.rd_lo), "rd_lo"
        want = np.bincount(np.clip(arr.rd_hi, 0, HIST_BINS - 1),
                           minlength=HIST_BINS)
        assert np.array_equal(hist, want), "all_reduced histogram"
        # both processes hold every cell's candidates
        n_cand = torch.tensor([cand["n"]])
        all_n = [torch.zeros_like(n_cand) for _ in range(world)]
        dist.all_gather(all_n, n_cand)
        assert cand["n"] > 0 and len({int(x) for x in all_n}) == 1
        print("MULTIHOST_OK rank=%d cands=%d" % (rank, cand["n"]),
              flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

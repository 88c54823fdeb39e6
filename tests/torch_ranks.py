"""Run the port's row-parallel loop ① as one process per instance, merged
with ``all_reduce_state`` over gloo, and any other script as one process a
rank; helpers of the port's sharded tests. It imports neither JAX nor the
JAX package, so the card tests use it too."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

_RANK = """
import sys
import numpy as np
import torch.distributed as dist
from repro_torch import interop
from repro_torch.core import pipeline as P, sharded_pipeline as SP
from repro_torch.launch.mesh import make_data_mesh

rank, world, addr, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
chunk_bytes, max_rows, device = int(sys.argv[5]), int(sys.argv[6]), sys.argv[7]
feed = np.load(path + "/feed.npz")
dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
cfg = P.PipelineConfig(chunk_bytes=chunk_bytes, max_rows_per_chunk=max_rows, device=device,
                       track_vocab_counts=True)
eng = SP.ShardedPiperPipeline(cfg, make_data_mesh(1, device=device))
local = eng.local_state(feed["stacks"][rank], feed["offsets"][rank])
merged = SP.all_reduce_state(local)
assert merged.first_pos.device == local.first_pos.device
fp, rows, counts = interop.vocab_state_to_numpy(merged)
np.savez(path + f"/rank{rank}.npz", first_pos=fp, rows_seen=rows, counts=counts)
dist.destroy_process_group()
print("OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(code: str, world: int, *args: str, timeout: float = 120) -> None:
    """``world`` processes of ``code`` on this host, rank ``r`` run as
    ``python -c code r world tcp://127.0.0.1:<port> *args``; each must exit
    0 and print OK."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), addr, *args],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "OK" in out, err[-4000:]


def run_ranks(world: int, stacks, offsets, tmp_path, *, chunk_bytes: int, max_rows: int,
              device: str = "cpu", timeout: float = 120) -> list[dict]:
    """``world`` processes on this host, rank ``k`` with shard ``k`` of the
    utf8 feed (``shard_stacks()``), each building its local state with
    count plane on ``device`` and calling ``all_reduce_state``; every
    rank's merged state as numpy arrays."""
    np.savez(Path(tmp_path) / "feed.npz", stacks=stacks, offsets=offsets)
    spawn_ranks(_RANK, world, str(tmp_path), str(chunk_bytes), str(max_rows), device,
                timeout=timeout)
    return [dict(np.load(Path(tmp_path) / f"rank{r}.npz")) for r in range(world)]

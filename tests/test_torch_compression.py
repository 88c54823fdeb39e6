"""The port's int8 gradient compression (repro_torch/distributed/
compression.py) against the JAX package's, bit for bit.

``quantize_int8``, ``dequantize_int8`` and ``compress_decompress`` run in
this process against the reference on one device. ``compressed_psum_mean``
runs over 3 rounds of error feedback: the reference's ``shard_map`` in one
JAX subprocess with 4 forced host devices on mesh (2, 2), over both axes
(4 shards) and over ``data`` alone (2 shards); the port's single-process
form on the same ``[n, ...]`` leaves, and its ``group=`` form in 2 gloo
processes (tests/torch_ranks.py), each rank with its own shard. Leaves:
shards of unequal magnitude, values on the rounding boundary, and an
all-zero leaf (its scale is 1e-12 / 127). Every code, scale, mean and
residual is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro_torch.distributed import compression as tcomp
from repro_torch.train.tree import leaves_with_paths
from tests.multidevice import run_with_devices
from tests.torch_ranks import spawn_ranks

ROUNDS = 3
N = 4
LEAVES = {"a": (37, 5), "b": (64,), "z": (3,)}

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] += " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
import numpy as np
import jax, jax.numpy as jnp
from repro.distributed import compression as comp
from repro.launch.mesh import make_mesh

d = {d!r}
inp = np.load(d + "/inputs.npz")
mesh = make_mesh((2, 2), ("data", "model"))
res = {{}}
for name, axes, n in (("both", ("data", "model"), 4), ("data", ("data",), 2)):
    err = {{k: jnp.zeros((n,) + inp[f"r0/{{k}}"].shape[1:], jnp.float32) for k in {leaves!r}}}
    for r in range({rounds}):
        g = {{k: jnp.asarray(inp[f"r{{r}}/{{k}}"][:n]) for k in err}}
        mean, err = comp.compressed_psum_mean(g, err, mesh, axes)
        for k in err:
            res[f"{{name}}/r{{r}}/mean/{{k}}"] = np.asarray(mean[k])
            res[f"{{name}}/r{{r}}/err/{{k}}"] = np.asarray(err[k])
np.savez(d + "/ref.npz", **res)
print("OK")
"""

_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.distributed import compression as comp

rank, world, addr, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
inp = np.load(d + "/inputs.npz")
dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
leaves = sorted(k.split("/")[1] for k in inp.files if k.startswith("r0/"))
err = comp.error_state_init({k: torch.from_numpy(inp["r0/" + k][rank]) for k in leaves})
out = {}
for r in range(int(sys.argv[5])):
    g = {k: torch.from_numpy(inp[f"r{r}/{k}"][rank]) for k in leaves}
    mean, err = comp.compressed_psum_mean(g, err, group=dist.group.WORLD)
    for k in leaves:
        out[f"r{r}/mean/{k}"], out[f"r{r}/err/{k}"] = mean[k].numpy(), err[k].numpy()
np.savez(d + f"/rank{rank}.npz", **out)
dist.destroy_process_group()
print("OK")
"""


def _inputs(seed=0) -> dict:
    """Per round and leaf, ``[N, ...]`` float32 gradients: shard k scaled
    by 10^(k-1), a row of values on a code's half step, the ``z`` leaf 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for r in range(ROUNDS):
        for k, shape in LEAVES.items():
            g = rng.standard_normal((N,) + shape).astype(np.float32)
            g *= (10.0 ** (np.arange(N) - 1)).astype(np.float32).reshape((N,) + (1,) * len(shape))
            if k == "b":
                g[:, :8] = (np.arange(8) + 0.5).astype(np.float32) / 127 * g[:, 8:9].max()
            out[f"r{r}/{k}"] = g if k != "z" else np.zeros((N,) + shape, np.float32)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("compression")
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)
    out = run_with_devices(_REFERENCE.format(d=str(d), leaves=tuple(LEAVES), rounds=ROUNDS),
                           n_devices=4, timeout=300)
    assert "OK" in out
    return {"dir": d, "inputs": inputs, **dict(np.load(d / "ref.npz"))}


def _eq(got: torch.Tensor, want, what):
    want = np.array(want)
    assert got.dtype == torch.from_numpy(want).dtype and tuple(got.shape) == want.shape, what
    assert np.array_equal(got.numpy().reshape(-1).view(np.uint8),
                          want.reshape(-1).view(np.uint8)), what


@pytest.mark.parametrize("leaf", list(LEAVES))
def test_local_rounds_match_the_reference(leaf):
    """quantize_int8 (code and scale), dequantize_int8 and three rounds of
    compress_decompress's error feedback, bit for bit."""
    inputs = _inputs(1)
    jerr = jnp.zeros(LEAVES[leaf], jnp.float32)
    terr = torch.zeros(LEAVES[leaf], dtype=torch.float32)
    for r in range(ROUNDS):
        x = inputs[f"r{r}/{leaf}"][r % N]
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
        _eq(tq, jq, "q")
        _eq(ts, js, "scale")
        _eq(tcomp.dequantize_int8(tq, ts), jcomp.dequantize_int8(jq, js), "dequant")
        jhat, jerr = jcomp.compress_decompress(jnp.asarray(x), jerr)
        that, terr = tcomp.compress_decompress(torch.from_numpy(x), terr)
        _eq(that, jhat, "x_hat")
        _eq(terr, jerr, "err")


@pytest.mark.parametrize("name,n", [("both", 4), ("data", 2)])
def test_psum_mean_matches_the_reference(ref, name, n):
    """The single-process form over leaves [n, ...], three rounds of error
    feedback: means and per-shard residuals bit for bit."""
    inputs = ref["inputs"]
    err = tcomp.error_state_init({k: torch.zeros((n,) + s) for k, s in LEAVES.items()})
    for r in range(ROUNDS):
        g = {k: torch.from_numpy(inputs[f"r{r}/{k}"][:n]) for k in LEAVES}
        mean, err = tcomp.compressed_psum_mean(g, err)
        for k in LEAVES:
            _eq(mean[k], ref[f"{name}/r{r}/mean/{k}"], (r, "mean", k))
            _eq(err[k], ref[f"{name}/r{r}/err/{k}"], (r, "err", k))


def test_psum_mean_over_gloo_matches_the_reference(ref):
    """The group= form in 2 processes, rank k holding shard k: every
    rank's mean and its own residuals bit for bit against the reference
    over the data axis (2 shards)."""
    d = ref["dir"]
    spawn_ranks(_RANK, 2, str(d), str(ROUNDS), timeout=120)
    for rank in range(2):
        got = dict(np.load(d / f"rank{rank}.npz"))
        for r in range(ROUNDS):
            for k in LEAVES:
                _eq(torch.from_numpy(got[f"r{r}/mean/{k}"]), ref[f"data/r{r}/mean/{k}"], k)
                _eq(torch.from_numpy(got[f"r{r}/err/{k}"]), ref[f"data/r{r}/err/{k}"][rank], k)


def test_residual_is_the_input_less_its_code_and_the_error_bound_holds(ref):
    """Per element the compressed mean is within scale / 2 of the plain
    mean of y = g + err, and the residual is y − dequant exactly."""
    inputs = ref["inputs"]
    g = {k: torch.from_numpy(inputs[f"r0/{k}"]) for k in LEAVES}
    err = tcomp.error_state_init(g)
    mean, new_err = tcomp.compressed_psum_mean(g, err)
    for path, y in leaves_with_paths(g):
        k = path[0]
        scale = torch.clamp(y.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
        assert torch.equal(new_err[k], y - q.to(torch.float32) * scale)
        assert float((mean[k] - y.mean(0)).abs().max()) <= float(scale) / 2

"""The port stands alone: it imports neither JAX nor the JAX package, runs
on the card unless asked for the CPU, and never falls back to the CPU
when there is no card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_RUN_PORT_ONLY = """
import sys
import numpy as np
from repro_torch.core import pipeline as P
from repro_torch.data import synth

buf, _ = synth.make_dataset(synth.SynthConfig(rows=50, seed=3))
pipe = P.PiperPipeline(P.PipelineConfig(chunk_bytes=8192, max_rows_per_chunk=64, device="cpu"))
outs = list(pipe.run_stream(lambda: synth.chunk_stream(buf, 8192)))
assert sum(int(o.valid.sum()) for o in outs) == 50

# a SMOKE DLRM on the CPU: one train step on Piper's rows, one checkpoint
import tempfile
import torch
from repro_torch.configs import piper_dlrm
from repro_torch.models import dlrm
from repro_torch.train import checkpoint, input_pipeline, optimizer, steps

model = dlrm.DLRM(piper_dlrm.SMOKE.model, device="cpu", generator=torch.Generator().manual_seed(0))
opt = optimizer.adamw_init(model.params_tree())
batch = next(input_pipeline.stream_batches(outs, batch_rows=32, n_steps=1))
metrics = steps.make_tabular_train_step(dlrm.loss, optimizer.AdamWConfig())(model, opt, batch)
assert bool(torch.isfinite(metrics["loss"]))
tree = {"params": model.params_tree(), "opt": opt, "extra": {"vocab": pipe.build_state_stream(
    synth.chunk_stream(buf, 8192))}}
with tempfile.TemporaryDirectory() as root:
    checkpoint.save(root, 1, tree)
    back = checkpoint.restore(root, checkpoint.latest_step(root), tree, device="cpu")
from repro_torch.train.tree import leaves
assert all(torch.equal(a, b.detach()) for a, b in zip(leaves(back), leaves(tree)))
# gemma-2b SMOKE: a prefill through the flash route and a served request
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serve import engine

model = lm.LM(configs.get_smoke("gemma-2b"), attn_impl="flash", device="cpu")
params = model.init(torch.Generator().manual_seed(0))
logits = steps.make_prefill_step(model)(params, {"tokens": torch.zeros((1, 32), dtype=torch.int32)})
assert bool(torch.isfinite(logits).all())
eng = engine.ServeEngine(model, params, batch_slots=2, cache_len=16)
req = engine.Request(prompt=[1, 2, 3], max_new_tokens=4)
eng.submit(req)
eng.run_until_drained()
assert len(req.generated) == 4
# the MoE, SSM and hybrid families at SMOKE: a prefill on the flash route
# and decode steps each, the engine on hymba (its rings wrap)
for arch in ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "xlstm-350m", "hymba-1.5b"):
    zoo_model = lm.LM(configs.get_smoke(arch), attn_impl="flash", device="cpu")
    zoo_params = zoo_model.init(torch.Generator().manual_seed(0))
    logits = steps.make_prefill_step(zoo_model)(
        zoo_params, {"tokens": torch.zeros((1, 48), dtype=torch.int32)})
    zoo_state = zoo_model.init_decode_state(1, 16)
    for pos in range(3):
        logits, zoo_state = steps.make_serve_step(zoo_model)(
            zoo_params, zoo_state, torch.tensor([pos], dtype=torch.int32), pos)
    assert bool(torch.isfinite(logits).all()), arch
eng = engine.ServeEngine(zoo_model, zoo_params, batch_slots=2, cache_len=48)
req = engine.Request(prompt=list(range(40)), max_new_tokens=4)
eng.submit(req)
eng.run_until_drained()
assert len(req.generated) == 4
# the streaming service with its observability and chunk cache, and the
# --piper-stream launcher
from repro_torch import obs
from repro_torch.data import chunk_cache
from repro_torch.launch import serve as serve_launcher
from repro_torch.stream import StreamingPreprocessService

pc = P.PipelineConfig(chunk_bytes=8192, max_rows_per_chunk=64, device="cpu")
state = P.PiperPipeline(pc).build_state_stream(synth.chunk_stream(buf, 8192))
with StreamingPreprocessService(pc, state, bucket_rows=(16, 64),
                                cache=chunk_cache.ChunkCache(1 << 20)) as svc:
    handles = [svc.submit(p) for p in synth.request_payloads(buf, None, [5, 20, 25])]
    svc.drain(timeout=120)
    assert sum(h.result(timeout=120)["label"].shape[0] for h in handles) == 50
assert obs.validate_trace(obs.tracer().to_chrome()) == []
snap = serve_launcher.main(["--piper-stream", "--rows", "300", "--device", "cpu"])
assert snap["rows"] == 300
# the row-wise baseline, and DLRM training fed by the service through the
# overlapped input pipeline (the e2e launcher's functions)
from repro_torch.core import baseline
from repro_torch.data import loader
from repro_torch.launch import train_dlrm_e2e

assert baseline.run_pipeline(buf, pc.schema, n_threads=2)["label"].shape[0] == 50
feed = train_dlrm_e2e.prepare(buf, pc.schema, payload_rows=25, device="cpu")
svc = train_dlrm_e2e.start_service(feed, chunk_cache.ChunkCache(1 << 20))
try:
    small = dlrm.DLRMConfig(embed_dim=8, bottom_mlp=(8,), top_mlp=(8, 1))
    report, _ = train_dlrm_e2e.train(svc, feed, small, optimizer.AdamWConfig(), steps=3,
                                     batch=25)
finally:
    svc.stop()
assert report["e2e_counters"]["batches_total"] == 3 and report["cache"]["hits_total"] >= 1
# LM training: the shapes, build_model, a Trainer step with a checkpoint,
# and the training launcher on Piper's tokens
from repro_torch.configs import shapes
from repro_torch.launch import specs
from repro_torch.launch import train as train_launcher
from repro_torch.train import trainer

cfg = configs.get_smoke("minitron-8b")
assert shapes.applicable(cfg, shapes.SHAPES["train_4k"]) == (True, "")
model = specs.build_model(cfg, device="cpu")
with tempfile.TemporaryDirectory() as root:
    tr = trainer.Trainer(model, optimizer.AdamWConfig(), trainer.TrainerConfig(
        total_steps=1, ckpt_dir=root, handle_signals=False),
        loader.TokenBatches(cfg.vocab_size, batch=2, seq=16))
    out = tr.run(0)
    assert out["final_step"] == 1 and checkpoint.latest_step(root) == 1
    out = train_launcher.main(["--arch", "minitron-8b", "--device", "cpu", "--steps", "1",
                               "--rows", "64", "--ckpt-dir", root + "/launcher"])
    assert out["final_step"] == 1
# the sharded engines: row-parallel and column-parallel, on CPU meshes
from repro_torch.core import sharded, sharded_pipeline
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib

mesh = mesh_lib.make_data_mesh(2, device="cpu")
feed = loader.TabularChunkFeed(buf, 8192, 2)
cs, os_ = sharding.put_shard_feed(*feed.shard_stacks(), mesh)
out = sharded_pipeline.ShardedPiperPipeline(pc, mesh).run_scan(cs, os_)
assert int(sharded_pipeline.flatten_sharded(out).valid.sum()) == 50
eng = sharded.ShardedPiper(pc, mesh_lib.make_mesh((2, 2), ("data", "model"), devices="cpu"))
assert int(eng.run_scan(feed.stacked, feed.offsets).valid.sum()) == 50
# the static gate, every pass, on the CPU
from repro_torch.analysis import __main__ as gate

assert gate.main(["--strict", "--device", "cpu"]) == 0
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", leaked)
"""


_RUN_CROSS_PORT_ONLY = """
import sys
import torch
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.models import lm
from repro_torch.train import steps

# whisper-small SMOKE: a prefill on the flash route, the encoder's output
# into the context caches, decode steps
cfg = configs.get_smoke("whisper-small")
model = specs.build_model(cfg, attn_impl="flash", device="cpu")
params = model.init(torch.Generator().manual_seed(0))
frames = torch.randn((2, cfg.encoder_frames, cfg.d_model), generator=torch.Generator().manual_seed(1))
tokens = torch.zeros((2, 16), dtype=torch.int32)
logits = steps.make_prefill_step(model)(params, {"tokens": tokens, "frames": frames})
state = model.decoder.fill_context_caches(
    params, model.decoder.init_decode_state(2, 8), model.encode(params, frames))
for pos in range(3):
    logits, state = steps.make_serve_step(model)(params, state, tokens[:, pos], pos)
assert bool(torch.isfinite(logits).all())
# llama-3.2-vision-90b SMOKE: the patches into the context caches, a decode step
cfg = configs.get_smoke("llama-3.2-vision-90b")
vlm = lm.LM(cfg, attn_impl="flash", device="cpu")
params = vlm.init(torch.Generator().manual_seed(0))
vision = torch.randn((1, cfg.vision_tokens, cfg.d_model), generator=torch.Generator().manual_seed(2))
state = vlm.fill_context_caches(params, vlm.init_decode_state(1, 8), vision)
assert all(bool(c["ctx_kv"]["k"].abs().sum() > 0) for sb in state for c in sb if "ctx_kv" in c)
logits, state = vlm.decode_step(params, torch.zeros(1, dtype=torch.int32), state, 0)
assert bool(torch.isfinite(logits).all())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", leaked)
"""


_RUN_SHARDED_PORT_ONLY = """
import sys
import tempfile
import torch
from repro_torch import configs, interop
from repro_torch.distributed import compression, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm, mlp
from repro_torch.train import checkpoint, optimizer, trainer

# qwen2-moe-a2.7b SMOKE: the expert-parallel MoE path, a sharded Trainer
# step under use_mesh, its checkpoint restored onto another mesh, the
# int8 compressed mean, the production mesh's rules
cfg = configs.get_smoke("qwen2-moe-a2.7b")
mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), devices="cpu")
params = mlp.moe_init(torch.Generator().manual_seed(0), cfg, "swiglu", device="cpu")
with sharding.use_mesh(mesh):
    out, aux = mlp.moe_forward(torch.randn(4, 8, cfg.d_model), params, cfg, "swiglu")
assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux))
model = lm.LM(cfg, device="cpu")
skeleton = model.init()
shardings = (sharding.param_shardings(skeleton, mesh),
             sharding.param_shardings(optimizer.adamw_init(skeleton), mesh),
             sharding.NamedSharding(mesh, sharding.batch_spec(mesh)))
with tempfile.TemporaryDirectory() as root:
    tr = trainer.Trainer(model, optimizer.AdamWConfig(), trainer.TrainerConfig(
        total_steps=1, ckpt_dir=root, handle_signals=False),
        lambda s: {"tokens": torch.zeros((4, 16), dtype=torch.int32)}, mesh=mesh,
        shardings=shardings)
    with sharding.use_mesh(mesh):
        run = tr.run(0)
    assert run["final_step"] == 1
    other = mesh_lib.make_mesh((1, 4), ("data", "model"), devices="cpu")
    back = checkpoint.restore(root, 1, interop.lm_train_state_like(cfg),
                              sharding_fn=lambda t: sharding.param_shardings(t, other))
    assert all(isinstance(st, sharding.ShardedTensor) for st in
               [back["params"]["embed"], back["opt"]["step"]])
grads = {"w": torch.randn(2, 5, 3)}
mean, err = compression.compressed_psum_mean(grads, compression.error_state_init(grads))
assert mean["w"].shape == (5, 3) and err["w"].shape == (2, 5, 3)
big = mesh_lib.make_production_mesh(multi_pod=True, devices="cpu")
assert sharding.param_shardings(skeleton, big)["embed"].spec == sharding.PartitionSpec(
    "model", ("pod", "data"))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", leaked)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_runs_without_jax_or_repro_in_sys_modules():
    """Piper's two loops, a DLRM train step and a checkpoint round trip, an
    LM prefill and a served request, the MoE, SSM and hybrid SMOKE models
    (a prefill, decode steps, a served request), the streaming service with its chunk
    cache and the --piper-stream launcher, the row-wise baseline and DLRM
    training fed by the service (the loader's prefetcher, the input
    pipeline, the e2e launcher), LM training (the shapes, build_model,
    a Trainer step and its checkpoint, the training launcher), both
    sharded engines' run_scan on CPU meshes, and the static gate
    (repro_torch.analysis --strict), in a process that never imports JAX or
    the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _RUN_PORT_ONLY], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    assert "LEAKED []" in out, out


def test_cross_attention_runs_without_jax_or_repro_in_sys_modules():
    """whisper-small SMOKE's prefill, context caches and decode steps, and
    llama-3.2-vision-90b SMOKE's fill_context_caches and a decode step, in a
    process that never imports JAX or the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _RUN_CROSS_PORT_ONLY], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    assert "LEAKED []" in out, out


def test_sharded_training_runs_without_jax_or_repro_in_sys_modules():
    """qwen2-moe-a2.7b SMOKE's expert-parallel MoE path, a sharded Trainer
    step under use_mesh and its checkpoint restored onto another mesh, the
    int8 compressed mean and the production mesh's rules, in a process that
    never imports JAX or the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _RUN_SHARDED_PORT_ONLY], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    assert "LEAKED []" in out, out


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_or_repro_imports(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_default_device_raises_without_a_card(monkeypatch):
    from repro_torch.core import pipeline as P

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.PipelineConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.PipelineConfig(device="cuda", input_format="binary")


def test_lm_entry_points_default_to_the_card(monkeypatch):
    """LM, ServeEngine (on an LM built with the defaults),
    lm_params_from_numpy, build_model, the serve and train launchers and
    the launcher's Piper tokens run on the card unless told otherwise, and
    raise without one."""
    from repro_torch import configs, interop
    from repro_torch.launch import serve, specs, train
    from repro_torch.models import lm
    from repro_torch.serve import engine

    cfg = configs.get_smoke("gemma-2b")
    tree = interop.lm_params_to_numpy(lm.LM(cfg, device="cpu").init(torch.Generator()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServeEngine(lm.LM(cfg), None, batch_slots=1, cache_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_params_from_numpy(tree, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma-2b", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "gemma-2b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        specs.build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.preprocess_tokens(64)


def test_streaming_service_defaults_to_the_card(monkeypatch):
    """The streaming service (through its config) and --piper-stream run on
    the card unless told otherwise, and raise without one."""
    from repro_torch.core import pipeline as P
    from repro_torch.core import vocab
    from repro_torch.launch import serve
    from repro_torch.stream import StreamingPreprocessService

    state = vocab.VocabState.init(26, 5000, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingPreprocessService(P.PipelineConfig(), state)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--piper-stream", "--rows", "64"])


def test_data_mesh_defaults_to_the_card(monkeypatch):
    """make_data_mesh and make_mesh put their positions on the card unless
    told otherwise (shard k on cuda:{k % device_count}), and raise without
    one."""
    from repro_torch.launch import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.make_data_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.make_data_mesh(3).devices == tuple(torch.device("cuda", k % 2) for k in range(3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_data_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh((2, 2), ("data", "model"))
    assert mesh.make_data_mesh(device="cpu").devices == (torch.device("cpu"),)


def test_kernel_wrappers_refuse_non_cuda_tensors():
    """The launch path checks its tensors; a CPU tensor never reaches it
    (the wrapper routes it to the plain version before)."""
    from repro_torch.kernels import _build

    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.check(torch.zeros(4, dtype=torch.int32), "x", torch.int32)


def test_chip_smoke_without_a_card_prints_no_result(tmp_path):
    """Without a card, and alone in a directory without the repository,
    chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card exit")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_chip_smoke_rehearsal_golden():
    """The smoke script's golden phase, rehearsed on the CPU."""
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--rehearse", "--phases", "golden"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert '"phase": "golden"' in r.stdout and '"ok": true' not in r.stdout.splitlines()[-1]


def test_chip_smoke_rehearsal_sharded():
    """The smoke script's sharded phase, rehearsed on the CPU."""
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--rehearse", "--phases", "sharded"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    assert '"phase": "sharded"' in r.stdout and '"ok": true' not in r.stdout.splitlines()[-1]

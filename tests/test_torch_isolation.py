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
batch = next(iter(input_pipeline.TrainInputPipeline(outs, batch_rows=32, n_steps=1)))
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
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", leaked)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_runs_without_jax_or_repro_in_sys_modules():
    """Piper's two loops, a DLRM train step and a checkpoint round trip, an
    LM prefill and a served request, in a process that never imports JAX or
    the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _RUN_PORT_ONLY], cwd=REPO, env=_env(),
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
    lm_params_from_numpy and the serve launcher run on the card unless told
    otherwise, and raise without one."""
    from repro_torch import configs, interop
    from repro_torch.launch import serve
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

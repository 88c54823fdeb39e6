"""The port's serving engine: greedy generation, continuous batching, and
the same tokens as the JAX package's engine on the same weights.

Ports of tests/test_serve.py's two tests (gemma-2b SMOKE stands in for
minitron-8b SMOKE, an architecture the port does not have yet), plus the
engine of both packages side by side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine


def _ref_greedy(model, params, prompt, n_new, cache_len):
    """Single-request greedy decode via decode_step."""
    state = model.init_decode_state(1, cache_len)
    out = []
    for pos in range(len(prompt) + n_new - 1):
        cur = prompt[pos] if pos < len(prompt) else out[-1]
        logits, state = model.decode_step(params, torch.tensor([cur], dtype=torch.int32),
                                          state, pos)
        if pos >= len(prompt) - 1:
            out.append(int(torch.argmax(logits[0])))
    return out[:n_new]


def _smoke(seed):
    cfg = tconfigs.get_smoke("gemma-2b")
    model = tlm.LM(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(seed))


def test_engine_matches_reference_greedy():
    _, model, params = _smoke(0)
    prompt = [5, 17, 123, 42]
    ref = _ref_greedy(model, params, prompt, n_new=6, cache_len=32)

    eng = tengine.ServeEngine(model, params, batch_slots=2, cache_len=32)
    req = tengine.Request(prompt=list(prompt), max_new_tokens=6)
    eng.submit(req)
    eng.run_until_drained()
    assert req.done
    assert req.generated == ref, (req.generated, ref)


def test_engine_batched_requests_drain():
    _, model, params = _smoke(1)
    eng = tengine.ServeEngine(model, params, batch_slots=4, cache_len=24)
    reqs = [tengine.Request(prompt=[i + 1, i + 2], max_new_tokens=4) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    assert all(len(r.generated) == 4 for r in reqs)


def test_engine_generates_the_reference_engines_tokens():
    """Both engines, 4 slots and 8 requests (two waves), on the JAX init's
    weights: the same greedy tokens. Both decode in bf16; argmax is
    compared, so this holds while no two logits of a step lie within the
    packages' rounding difference of each other (true for these weights
    and prompts, which are fixed)."""
    jcfg = jconfigs.get_smoke("gemma-2b")
    jmodel = jlm.LM(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    tcfg = tconfigs.get_smoke("gemma-2b")
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                           device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, 6).tolist() for _ in range(8)]
    out = []
    for lib, model, params in ((jengine, jmodel, jparams),
                               (tengine, tlm.LM(tcfg, device="cpu"), tparams)):
        eng = lib.ServeEngine(model, params, batch_slots=4, cache_len=32)
        reqs = [lib.Request(prompt=list(p), max_new_tokens=5) for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        assert all(r.done and len(r.generated) == 5 for r in reqs)
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]
    assert jnp.asarray(out[0]).shape == (8, 5)


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch import serve as tserve

    reqs = tserve.main(["--arch", "gemma-2b", "--device", "cpu", "--requests", "3",
                        "--new-tokens", "4"])
    assert [len(r.generated) for r in reqs] == [4, 4, 4]
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out

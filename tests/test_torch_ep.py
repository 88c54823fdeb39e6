"""The port's expert-parallel MoE path, its sharded Trainer and elastic
restore, against the JAX package's, at qwen2-moe-a2.7b SMOKE (8 experts,
top-2, one shared expert), float32, on mesh (2, 2) over ("data", "model").

One JAX subprocess with 4 forced host devices (tests/multidevice.py)
writes every reference array once: ``_moe_forward_ep`` with
``capacity_factor`` lowered to 1.0 (so capacity drops happen) and the
gradients of ``sum(out · r) + 3 · aux``; the reference's
``Trainer(mesh=, shardings=)`` for 2 steps under ``use_mesh`` (float32
compute, from a step-0 checkpoint both packages resume); and its elastic
restore of the port's checkpoint onto its mesh. Tolerances, each beside
the gap measured on this CPU:
  * the layer's output 1e-5 of its largest value (measured 1.8e-7), the
    auxiliary loss 1e-6 relative (measured 0), every gradient 1e-5 of its
    largest entry (measured at most 3.0e-7): the bounds of
    tests/test_torch_moe.py;
  * the port's EP path against its dense path run per data shard: 1e-6
    of the largest value (measured 0), auxiliary 1e-6 relative;
  * trainer losses 1e-5 relative (measured 7e-8), and at most 2% of a
    leaf's weights more than lr apart (tests/test_torch_lm_train.py's
    weight check; measured 0, the largest gap 2.3e-5 at lr 1e-3 after 2
    steps against the reference): AdamW's step is about lr·sign(m), so an
    element whose gradient is rounding noise around 0 (an embedding row no
    token used) may step the other way, by up to 2·lr, with any change of
    summation order, such as the CPU's thread count;
  * the port's sharded Trainer against its unsharded one, the restored
    checkpoints, the port's resumes on any mesh and the ShardedTensor
    blocks: bit for bit (one process runs the same step on the same
    whole tensors).
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.train.tree import leaves, leaves_with_paths
from tests.multidevice import run_with_devices

ARCH = "qwen2-moe-a2.7b"
F32_REL = 1e-5
AUX_REL = 1e-6
EP_DENSE_REL = 1e-6
LOSS_REL = 1e-5
LR = 1e-3
SIGN_FLIP_FRAC = 0.02
STEPS = 2
BATCH, SEQ = 4, 32

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] += " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.distributed import sharding as shard_lib
from repro.launch.mesh import make_mesh
from repro.models import lm as jlm, mlp as jmlp
from repro.train import checkpoint as ckpt, optimizer as opt_lib, trainer as trainer_lib

out_dir, port_ckpt = {out_dir!r}, {port_ckpt!r}
inp = np.load(out_dir + "/inputs.npz")
cfg = configs.get_smoke("qwen2-moe-a2.7b")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
mesh = make_mesh((2, 2), ("data", "model"))
key = lambda path: "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
res = {{}}

params = jmlp.moe_init(jax.random.PRNGKey(0), cfg, "swiglu")
for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
    res["layer/" + key(path)] = np.asarray(v)

def f(p, x):
    out, aux = jmlp.moe_forward(x, p, cfg, "swiglu")
    return jnp.sum(out * inp["r"]) + 3.0 * aux, (out, aux)

with shard_lib.use_mesh(mesh):
    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(inp["x"]))
res["ep/out"], res["ep/aux"], res["ep/gx"] = np.asarray(out), np.asarray(aux), np.asarray(gx)
for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]:
    res["ep/grad/" + key(path)] = np.asarray(v)

class F32(jlm.LM):
    def hidden(self, params, tokens, context=None, compute_dtype=jnp.float32):
        return super().hidden(params, tokens, context, jnp.float32)

model = F32(cfg)
init = model.init(jax.random.PRNGKey(1))
root = out_dir + "/jax_ckpt"
ckpt.save(root, 0, {{"params": init, "opt": opt_lib.adamw_init(init)}})
skeleton = jax.eval_shape(model.init, jax.random.PRNGKey(1))
like = {{"params": skeleton, "opt": jax.eval_shape(opt_lib.adamw_init, skeleton)}}
p_sh = shard_lib.param_shardings(skeleton, mesh)
o_sh = shard_lib.param_shardings(like["opt"], mesh)
b_sh = {{"tokens": jax.sharding.NamedSharding(mesh, shard_lib.batch_spec(mesh))}}
tr = trainer_lib.Trainer(model, opt_lib.AdamWConfig(), trainer_lib.TrainerConfig(
    total_steps={steps}, ckpt_dir=root, ckpt_every=100, handle_signals=False),
    lambda s: {{"tokens": jnp.asarray(inp["tokens"][s])}}, mesh=mesh,
    shardings=(p_sh, o_sh, b_sh))
with shard_lib.use_mesh(mesh):
    res["trainer/losses"] = np.asarray(tr.run(jax.random.PRNGKey(1))["losses"])

back = ckpt.restore(port_ckpt, 1, like, sharding_fn=lambda t: shard_lib.param_shardings(t, mesh))
want = ckpt.restore(port_ckpt, 1, like)
n = 0
for leaf, plain, sh in zip(jax.tree.leaves(back), jax.tree.leaves(want),
                           jax.tree.leaves(shard_lib.param_shardings(like, mesh))):
    assert leaf.sharding == sh and np.array_equal(np.asarray(leaf), plain)
    n += 1
res["restore/leaves"] = np.asarray(n)
specs = {{key(path): [list(e) if isinstance(e, tuple) else e for e in sh.spec]
         for path, sh in jax.tree_util.tree_flatten_with_path(
             shard_lib.param_shardings(like, mesh))[0]}}
with open(out_dir + "/specs.json", "w") as f:
    json.dump(specs, f)
np.savez(out_dir + "/ref.npz", **res)
print("OK")
"""


def _cfg(capacity_factor=1.0):
    cfg = tconfigs.get_smoke(ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=capacity_factor))


def _mesh(shape=(2, 2)):
    return tmesh.make_mesh(shape, ("data", "model"), devices="cpu")


class F32LM(tlm.LM):
    """The LM with float32 compute in its loss (the reference subprocess's
    ``F32`` does the same to the JAX package's)."""

    def loss(self, params, tokens, compute_dtype=torch.float32, aux_weight=0.01, context=None):
        return super().loss(params, tokens, torch.float32, aux_weight, context)


def _shardings(model, mesh):
    skeleton = model.init()
    return (tsharding.param_shardings(skeleton, mesh),
            tsharding.param_shardings(topt.adamw_init(skeleton), mesh),
            tsharding.NamedSharding(mesh, tsharding.batch_spec(mesh)))


def _trainer(root, tokens, *, mesh=None, microbatches=1, total_steps=STEPS, ckpt_every=100,
             cfg=None):
    model = F32LM(cfg or _cfg(), device="cpu")
    tcfg = ttrainer.TrainerConfig(total_steps=total_steps, ckpt_dir=str(root),
                                  ckpt_every=ckpt_every, microbatches=microbatches,
                                  handle_signals=False)
    return ttrainer.Trainer(model, topt.AdamWConfig(), tcfg,
                            lambda s: {"tokens": tokens[s]}, mesh=mesh,
                            shardings=None if mesh is None else _shardings(model, mesh))


def _run(tr, use_mesh=None):
    if use_mesh is None:
        return tr.run(0)
    with tsharding.use_mesh(use_mesh):
        return tr.run(0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Each case is a SMOKE model: one thread a process, so that the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, one_thread):
    """The inputs, a port checkpoint (one sharded step) for the reference
    to restore, and the reference's arrays."""
    d = tmp_path_factory.mktemp("ep")
    rng = np.random.default_rng(0)
    cfg = _cfg()
    inputs = dict(x=rng.standard_normal((BATCH, 24, cfg.d_model)).astype(np.float32),
                  r=rng.standard_normal((BATCH, 24, cfg.d_model)).astype(np.float32),
                  tokens=rng.integers(0, cfg.vocab_size, (STEPS + 2, BATCH, SEQ)).astype(np.int32))
    np.savez(d / "inputs.npz", **inputs)
    _run(_trainer(d / "port_ckpt", inputs["tokens"], mesh=_mesh(), total_steps=1))
    out = run_with_devices(_REFERENCE.format(out_dir=str(d), port_ckpt=str(d / "port_ckpt"),
                                             steps=STEPS), n_devices=4, timeout=600)
    assert "OK" in out
    return {"dir": d, **inputs, **dict(np.load(d / "ref.npz")),
            "specs": json.loads((d / "specs.json").read_text())}


def _layer_params(ref, grad: bool = False) -> dict:
    """The reference's layer weights, as leaf tensors with gradients on
    when ``grad``."""
    t = lambda k: torch.from_numpy(ref["layer/" + k]).requires_grad_(grad)
    return {"router": {"w": t("router/w")}, "w_gate": t("w_gate"), "w_up": t("w_up"),
            "w_down": t("w_down"),
            "shared": {k: {"w": t(f"shared/{k}/w")} for k in ("gate", "up", "down")}}


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    gap = float(np.abs(got - want).max())
    assert gap <= rel * max(float(np.abs(want).max()), 1e-30), (what, gap)


# --------------------------------------------------------------------- #
# the expert-parallel layer
# --------------------------------------------------------------------- #
def test_ep_layer_and_its_gradients_match_the_reference(ref):
    """Forward, auxiliary loss and every gradient (router, experts, shared
    expert, input) of the EP path under use_mesh, with capacity drops."""
    params = _layer_params(ref, grad=True)
    x = torch.from_numpy(ref["x"]).requires_grad_()
    with tsharding.use_mesh(_mesh()):
        out, aux = tmlp.moe_forward(x, params, _cfg(), "swiglu")
        (torch.sum(out * torch.from_numpy(ref["r"])) + 3.0 * aux).backward()
    _close(out.detach(), ref["ep/out"], F32_REL, "out")
    assert abs(float(aux.detach()) / float(ref["ep/aux"]) - 1) <= AUX_REL
    _close(x.grad, ref["ep/gx"], F32_REL, "x")
    for path, p in leaves_with_paths(params):
        _close(p.grad, ref["ep/grad/" + "/".join(path)], F32_REL, path)


@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 8), (4, 2)], ids=str)
def test_ep_path_equals_the_dense_path_per_data_shard(shape, capacity_factor, ref):
    """The EP output is the dense path run on each data shard's rows and
    concatenated; its auxiliary loss is the mean of the shards'. At
    capacity 1.0 some choices drop, at 8.0 none."""
    cfg = _cfg(capacity_factor)
    params = _layer_params(ref)
    x = torch.from_numpy(ref["x"])
    mesh = _mesh(shape)
    with tsharding.use_mesh(mesh):
        out, aux = tmlp.moe_forward(x, params, cfg, "swiglu")
    shards = x.chunk(shape[0])
    dense = [tmlp._moe_forward_dense(xs, params, cfg, "swiglu") for xs in shards]
    _close(out, torch.cat([o for o, _ in dense]), EP_DENSE_REL, "out")
    want_aux = float(torch.stack([a for _, a in dense]).mean())
    assert abs(float(aux) / want_aux - 1) <= AUX_REL
    drops = [int((~tmlp.moe_route(xs.reshape(-1, cfg.d_model), params, cfg)["keep"]).sum())
             for xs in shards]
    assert (sum(drops) > 0) == (capacity_factor == 1.0), drops


def test_moe_forward_takes_the_dense_path_where_the_reference_does(ref):
    """No mesh, a model axis of 1, or one that does not divide the expert
    count: the dense path, equal to it bit for bit. A batch the data axes
    do not split raises."""
    cfg = _cfg()
    params = _layer_params(ref)
    x = torch.from_numpy(ref["x"])
    dense, dense_aux = tmlp._moe_forward_dense(x, params, cfg, "swiglu")
    for mesh in (None, _mesh((4, 1)), _mesh((1, 3))):
        ctx = tsharding.use_mesh(mesh) if mesh is not None else torch.no_grad()
        with ctx:
            out, aux = tmlp.moe_forward(x, params, cfg, "swiglu")
        assert torch.equal(out, dense) and torch.equal(aux, dense_aux)
    with tsharding.use_mesh(_mesh((8, 2))):
        with pytest.raises(ValueError, match="does not split over 8 data shards"):
            tmlp.moe_forward(x, params, cfg, "swiglu")
    assert tsharding.current_mesh() is None


def test_remat_recomputes_on_the_forwards_path_from_another_thread():
    """A CUDA backward runs on the autograd engine's own thread, where
    use_mesh's context is unset: a remat superblock must still recompute
    its MoE layer on the EP path, as in the forward. The backward run from
    a fresh thread gives the same-thread backward's gradients bit for
    bit."""
    import threading

    cfg = _cfg()
    model = tlm.LM(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 32), dtype=np.int32))
    grads = []
    for thread in (False, True):
        params = model.init(torch.Generator().manual_seed(0))
        for p in leaves(params):
            p.requires_grad_(True)
        with tsharding.use_mesh(_mesh()):
            loss = model.loss(params, tokens, torch.float32)
        errors = []

        def backward():
            try:
                loss.backward()
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        if thread:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        assert not errors, errors
        grads.append([p.grad for p in leaves(params)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# --------------------------------------------------------------------- #
# the sharded Trainer
# --------------------------------------------------------------------- #
def _resume_dir(ref, root):
    """A copy of the reference's step-0 checkpoint for a port Trainer."""
    shutil.copytree(ref["dir"] / "jax_ckpt" / "step_00000000", root / "step_00000000")
    return root


def _final_params_of_the_reference(ref):
    like = interop.lm_train_state_like(_cfg())
    back = tckpt.restore(str(ref["dir"] / "jax_ckpt"), STEPS, like, device="cpu")
    return {"/".join(p): v.numpy() for p, v in leaves_with_paths(back["params"])}


def _close_params(got_params, want: dict, what: str):
    got = {"/".join(p): v for p, v in leaves_with_paths(interop.lm_params_to_numpy(got_params))}
    assert got.keys() == want.keys()
    for k in want:
        flips = float(np.mean(np.abs(got[k] - want[k]) > LR))
        assert flips <= SIGN_FLIP_FRAC, (what, k, flips)


def test_sharded_trainer_matches_the_reference(ref, tmp_path):
    """Two steps of Trainer(mesh=, shardings=) under use_mesh (the EP path
    with autograd) from the same step-0 checkpoint and batches."""
    run = _run(_trainer(_resume_dir(ref, tmp_path), ref["tokens"], mesh=_mesh()), _mesh())
    assert run["final_step"] == STEPS
    np.testing.assert_allclose(run["losses"], ref["trainer/losses"], rtol=LOSS_REL, atol=0)
    _close_params(run["params"], _final_params_of_the_reference(ref), "params")


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("ep", [True, False], ids=["under_use_mesh", "dense_path"])
def test_sharded_trainer_matches_the_unsharded_trainer(ep, microbatches, ref, tmp_path):
    """The port's sharded Trainer against its unsharded one over the
    global batch, under the same use_mesh (each data shard routed alone,
    EP) or none (MoE's dense path): the same losses and weights bit for
    bit."""
    mesh = _mesh()
    runs = [_run(_trainer(_resume_dir(ref, tmp_path / name), ref["tokens"], mesh=m,
                          microbatches=microbatches), mesh if ep else None)
            for name, m in (("plain", None), ("sharded", mesh))]
    assert runs[1]["losses"] == runs[0]["losses"]
    for key in ("params", "opt_state"):
        assert all(torch.equal(a, b) for a, b in zip(leaves(runs[1][key]), leaves(runs[0][key])))


def test_sharded_trainer_holds_its_state_as_views(ref, tmp_path):
    """Parameters and AdamW moments are held as the blocks of p_sh / o_sh,
    views of the whole tensors: no copy is made."""
    mesh = _mesh()
    run = _run(_trainer(_resume_dir(ref, tmp_path), ref["tokens"], mesh=mesh), mesh)
    placement = run["placement"]
    for tree, whole in ((placement["params"], run["params"]),
                        (placement["opt"], run["opt_state"])):
        for st, t in zip(leaves(tree), leaves(whole)):
            assert isinstance(st, tsharding.ShardedTensor) and len(st.blocks) == 4
            assert all(b.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
                       for b in st.blocks)
            assert torch.equal(st.full(), t.detach())
    moe = placement["params"]["blocks"][0][0]["mlp"]["w_gate"]
    assert moe.sharding.spec == tsharding.PartitionSpec("model", "data", None)
    assert moe.blocks[1].shape == (4, moe.shape[1] // 2, moe.shape[2])


def test_trainer_with_a_mesh_off_the_models_device_raises(tmp_path):
    model = F32LM(_cfg(), device="cpu")
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), devices=["cpu", "cpu", "cpu", "meta"])
    with pytest.raises(ValueError, match="model's device"):
        ttrainer.Trainer(model, topt.AdamWConfig(), ttrainer.TrainerConfig(), lambda s: {},
                         mesh=mesh, shardings=_shardings(model, _mesh()))
    with pytest.raises(ValueError, match=r"\(params_sh, opt_sh, batch_sh\)"):
        ttrainer.Trainer(model, topt.AdamWConfig(), ttrainer.TrainerConfig(), lambda s: {},
                         mesh=_mesh(), shardings=_shardings(model, _mesh())[:2])


# --------------------------------------------------------------------- #
# elastic restore
# --------------------------------------------------------------------- #
def test_restore_places_the_reference_checkpoint_on_a_mesh(ref):
    """The reference's step-2 checkpoint restored with a sharding_fn: each
    leaf a ShardedTensor with the reference's spec, blocks that are views
    of one copy, and the checkpoint's values bit for bit."""
    mesh = _mesh()
    root = str(ref["dir"] / "jax_ckpt")
    like = interop.lm_train_state_like(_cfg())
    back = tckpt.restore(root, STEPS, like,
                         sharding_fn=lambda t: tsharding.param_shardings(t, mesh))
    plain = dict(leaves_with_paths(tckpt.restore(root, STEPS, like, device="cpu")))
    n = 0
    for path, st in leaves_with_paths(back):
        spec = [tuple(e) if isinstance(e, list) else e for e in ref["specs"]["/".join(path)]]
        assert st.sharding.spec == tsharding.PartitionSpec(*spec), path
        assert len({b.untyped_storage().data_ptr() for b in st.blocks}) == 1
        assert torch.equal(st.full(), plain[path])
        n += 1
    assert n == len(ref["specs"])


def test_reference_restores_the_port_checkpoint_on_its_mesh(ref):
    """The port's sharded Trainer's checkpoint, restored by the reference
    with a sharding_fn on its 4-device mesh: every leaf with the sharding
    param_shardings gives and the file's values (checked in the
    subprocess)."""
    like = interop.lm_train_state_like(_cfg())
    assert int(ref["restore/leaves"]) == len(leaves(like)) == len(ref["specs"])


@pytest.mark.parametrize("resume", ["same_mesh", "other_mesh", "no_mesh"])
def test_elastic_resume(resume, ref, tmp_path):
    """Four steps under mesh (2, 2) with a checkpoint at step 2 (MoE's
    dense path: no use_mesh); a new Trainer resumes that checkpoint on the
    same mesh, on (1, 4) or with no mesh: the same step-2 state, and steps
    3-4 equal to the uninterrupted run's, bit for bit."""
    tokens = ref["tokens"]
    full = _run(_trainer(_resume_dir(ref, tmp_path / "full"), tokens, mesh=_mesh(),
                         total_steps=4, ckpt_every=2))
    root = tmp_path / "resumed"
    shutil.copytree(tmp_path / "full" / "step_00000002", root / "step_00000002")
    mesh = {"same_mesh": _mesh(), "other_mesh": _mesh((1, 4)), "no_mesh": None}[resume]
    tr = _trainer(root, tokens, mesh=mesh, total_steps=4, ckpt_every=100)
    p2, o2 = tr._restore(2)
    saved = tckpt.restore(str(root), 2, interop.lm_train_state_like(_cfg()), device="cpu")
    assert all(torch.equal(torch.from_numpy(np.asarray(a)), b) for a, b in
               zip(leaves(interop.lm_train_state_to_numpy(p2, o2)), leaves(saved)))
    out = _run(tr)
    assert out["final_step"] == 4 and len(out["losses"]) == 2
    assert out["losses"] == full["losses"][2:]
    for key in ("params", "opt_state"):
        assert all(torch.equal(a, b) for a, b in zip(leaves(out[key]), leaves(full[key])))

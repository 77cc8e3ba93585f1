"""The port's training (models/train.py) against the JAX package's, on the
CPU, in f32, at the tiny sizes: ``tiny``, ``tiny_gemma`` and
``tiny_moe``, weights drawn by the reference and carried across
(``params_from_jax``), token ids from numpy seeds.

Tolerances (all f32): logits atol 2e-5 (both sum the same products in
other orders); the loss rtol 2e-6; gradients atol 2e-6 + rtol 1e-4;
after a step, parameters and moments atol 2e-6 + rtol 1e-5. Adam's
update ``m / (sqrt(v) + eps)`` divides rounding noise by itself where a
gradient is within eps (1e-8) of zero: in the FIRST step (when
``m/sqrt(v)`` is ``g/|g|``) such elements may land anywhere in ±lr, so
the comparison excludes the elements whose reference gradient has
``0 < |g| < 1e-6`` and counts them (at most 1% of a leaf).

On a mesh (``dp`` x ``ep`` on ``tiny_moe``, ``sp`` x ``tp`` and ``dp``
x ``sp`` on ``tiny``) the port's step is held against the JAX step on one
device from the same state, once with the replicated weights SHARED
between the ranks of one device (``Mesh.replicate``: autograd sums their
gradient) and once as per-rank COPIES (the step sums them): a second
sum over a shared tensor would double its gradient and fail the
comparison.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu.models import moe as jmoe
from llm_d_fast_model_actuation_tpu.models import train as jtrain
from llm_d_fast_model_actuation_tpu.models.registry import init_params_for
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models import train as ttrain
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax, train_state_from_jax
from llm_d_fast_model_actuation_tpu_torch.parallel import mesh as tmesh

CONFIGS = {
    "tiny": jllama.LlamaConfig.tiny,
    "tiny_gemma": jllama.LlamaConfig.tiny_gemma,
    "tiny_moe": jmoe.MoeConfig.tiny_moe,
}
LOGITS_ATOL = 2e-5
LOSS_RTOL = 2e-6
NEAR_ZERO_GRAD = 1e-6


def _setup(name, seed=0, batch=2, seq=16):
    jc = dataclasses.replace(CONFIGS[name](), dtype=jnp.float32)
    jp = init_params_for(jax.random.key(seed), jc)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jc.vocab_size, (batch, seq)).astype(np.int32)
    seq_lens = np.asarray([seq, seq - 5, seq - 8, 3][:batch], np.int32)
    return jc, jp, config_from_jax(jc), tokens, seq_lens


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_close(got: torch.Tensor, want, what: str, atol=2e-6, rtol=1e-5, skip=None) -> int:
    """Compare, excluding ``skip`` (a bool mask) and returning how many
    elements it excluded."""
    g, w = got.detach().numpy(), np.asarray(want, np.float32)
    if skip is not None:
        g, w = g[~skip], w[~skip]
    np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=what)
    return 0 if skip is None else int(skip.sum())


def _grads_near_zero(jp, jc, tokens, seq_lens):
    g = jax.grad(jtrain.lm_loss)(jp, jc, jnp.asarray(tokens), jnp.asarray(seq_lens))
    out = {}
    for k, v in params_from_jax(_np(g)).items():
        a = np.abs(v.numpy())
        out[k] = (a > 0) & (a < NEAR_ZERO_GRAD)  # an exact zero updates exactly in both
    return out


def _compare_state(ts, js, what, near_zero=None):
    """The port's state (whole, on the CPU) against the JAX one: params,
    mu and nu, with the first step's near-zero-gradient elements
    excluded and counted."""
    want_p = params_from_jax(_np(js.params))
    want_mu, want_nu = params_from_jax(_np(js.opt_state[0].mu)), params_from_jax(_np(js.opt_state[0].nu))
    excluded = 0
    for k in want_p:
        skip = None if near_zero is None else near_zero[k]
        excluded += _assert_close(ts.params[k], want_p[k], f"{what} params {k}", skip=skip)
        _assert_close(ts.opt_state.mu[k], want_mu[k], f"{what} mu {k}")
        _assert_close(ts.opt_state.nu[k], want_nu[k], f"{what} nu {k}", atol=1e-9)
        if skip is not None:
            assert skip.sum() <= max(1, skip.size // 100), (k, int(skip.sum()))
    assert ts.opt_state.count == int(js.opt_state[0].count) and ts.step == int(js.step)
    return excluded


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_train_matches_the_reference(name, remat):
    jc, jp, tc, tokens, seq_lens = _setup(name)
    want = jtrain.forward_train(jp, jc, jnp.asarray(tokens), jnp.asarray(seq_lens), remat=remat)
    got = ttrain.forward_train(params_from_jax(_np(jp)), tc, torch.from_numpy(tokens), torch.from_numpy(seq_lens),
                               remat=remat)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _assert_close(got, want, "logits", atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_loss_and_its_gradients_match_the_reference(name):
    jc, jp, tc, tokens, seq_lens = _setup(name, seed=1)
    want, want_g = jax.value_and_grad(jtrain.lm_loss)(jp, jc, jnp.asarray(tokens), jnp.asarray(seq_lens))
    params = {k: v.requires_grad_() for k, v in params_from_jax(_np(jp)).items()}
    loss = ttrain.lm_loss(params, tc, torch.from_numpy(tokens), torch.from_numpy(seq_lens))
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    loss.backward()
    for k, g in params_from_jax(_np(want_g)).items():
        _assert_close(params[k].grad, g, f"grad {k}", atol=2e-6, rtol=1e-4)


def test_lm_loss_masks_as_the_reference_and_counts_at_least_one():
    """Rows of length 1 have no target: the mask is empty, and the loss
    divides by max(0, 1) = 1, giving 0 in both packages."""
    jc, jp, tc, tokens, _ = _setup("tiny", seed=2)
    seq_lens = np.asarray([1, 1], np.int32)
    want = jtrain.lm_loss(jp, jc, jnp.asarray(tokens), jnp.asarray(seq_lens))
    got = ttrain.lm_loss(params_from_jax(_np(jp)), tc, torch.from_numpy(tokens), torch.from_numpy(seq_lens))
    assert float(want) == float(got) == 0.0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_train_steps_from_a_carried_state_match_the_reference(name):
    """The reference takes a step; its state (parameters, adamw's mu, nu
    and count) is carried across; then both take two more steps, held
    together after each."""
    jc, jp, tc, tokens, seq_lens = _setup(name, seed=3)
    opt = jtrain.make_optimizer()
    js, _ = jtrain.train_step(jtrain.make_train_state(jp, opt), jc, jnp.asarray(tokens), jnp.asarray(seq_lens), opt)
    ts = train_state_from_jax(js.step, _np(js.params), _np(js.opt_state[0]))
    assert ts.step == 1 and ts.opt_state.count == 1
    for step in range(2):
        js, jm = jtrain.train_step(js, jc, jnp.asarray(tokens), jnp.asarray(seq_lens), opt)
        ts, tm = ttrain.train_step(ts, tc, torch.from_numpy(tokens), torch.from_numpy(seq_lens))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        _compare_state(ts, js, f"{name} step {step + 2}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_first_train_step_matches_the_reference(name):
    jc, jp, tc, tokens, seq_lens = _setup(name, seed=4)
    opt = jtrain.make_optimizer()
    js, jm = jtrain.train_step(jtrain.make_train_state(jp, opt), jc, jnp.asarray(tokens), jnp.asarray(seq_lens), opt)
    ts, tm = ttrain.train_step(ttrain.make_train_state(params_from_jax(_np(jp))), tc, torch.from_numpy(tokens),
                               torch.from_numpy(seq_lens))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    _compare_state(ts, js, f"{name} step 1", near_zero=_grads_near_zero(jp, jc, tokens, seq_lens))


def test_optimizer_is_adamw_with_the_references_settings():
    opt = ttrain.make_optimizer()
    assert (opt.lr, opt.b1, opt.b2, opt.eps, opt.weight_decay) == (3e-4, 0.9, 0.999, 1e-8, 0.01)
    # every leaf decays, norms included: a zero gradient still moves a weight
    p = torch.ones(3)
    mu, nu = torch.zeros(3), torch.zeros(3)
    opt.apply_(p, torch.zeros(3), mu, nu, 1)
    assert torch.allclose(p, torch.full((3,), 1 - 3e-4 * 0.01))


@pytest.mark.parametrize("name", ["tiny", "tiny_gemma", "tiny_moe"])
def test_training_forward_is_the_serving_function(name):
    """``forward_train`` and the port's serving prefill compute the same
    function (the reference's ``test_gemma_train_matches_serving_function``,
    at f32 and atol 1e-5)."""
    jc, jp, tc, _, _ = _setup(name, seed=5)
    state = params_from_jax(_np(jp))
    tokens = torch.tensor([[5, 6, 7, 8, 9, 10]], dtype=torch.int32)
    seq_lens = torch.tensor([6], dtype=torch.int32)
    logits_t = ttrain.forward_train(state, tc, tokens, seq_lens, remat=False)
    assert float(logits_t.abs().max()) > 0
    model = tllama.Llama(tc, "cpu")
    model.load_state_dict(state)
    page_size, num_pages = 8, 16
    shape = (tc.num_layers, num_pages, page_size, tc.num_kv_heads, tc.head_dim)
    cache = (torch.zeros(shape, dtype=tc.dtype), torch.zeros(shape, dtype=tc.dtype))
    table = torch.arange(1, 9, dtype=torch.int32).reshape(1, 8)
    logits_s = tllama.prefill(model, tokens, seq_lens, cache, table)
    _assert_close(logits_t[0, :6], logits_s[0, :6].numpy(), "train vs serve", atol=1e-5, rtol=0)


MESHES = [
    ("tiny_moe", dict(dp=2, ep=2)),
    ("tiny", dict(sp=2, tp=2)),
    ("tiny", dict(dp=2, sp=2)),
]


@pytest.mark.parametrize("copies", [False, True], ids=["shared", "copies"])
@pytest.mark.parametrize("name,plan", MESHES, ids=lambda x: x if isinstance(x, str) else ",".join(f"{k}={v}" for k, v in x.items()))
def test_mesh_train_step_matches_the_reference_on_one_device(name, plan, copies):
    jc, jp, tc, tokens, seq_lens = _setup(name, seed=6, batch=4, seq=16)
    opt = jtrain.make_optimizer()
    js, jm = jtrain.train_step(jtrain.make_train_state(jp, opt), jc, jnp.asarray(tokens), jnp.asarray(seq_lens), opt)
    mplan = tmesh.MeshPlan(**plan)
    mesh = tmesh.make_mesh(mplan, ["cpu"] * mplan.size)
    sharded = ttrain.shard_train_params(params_from_jax(_np(jp)), tc, mesh)
    if copies:  # every rank its own tensor, as ranks on separate cards hold them
        sharded = {k: [t.clone() for t in v] for k, v in sharded.items()}
    norms = sharded["final_norm"]  # replicated over every axis
    assert len({id(t) for t in norms}) == (mesh.size if copies else 1)
    logits = ttrain.forward_train(sharded, tc, torch.from_numpy(tokens), torch.from_numpy(seq_lens), mesh=mesh)
    want = jtrain.forward_train(jp, jc, jnp.asarray(tokens), jnp.asarray(seq_lens))
    _assert_close(logits, want, "mesh logits", atol=LOGITS_ATOL, rtol=0)
    ts, tm = ttrain.train_step(ttrain.make_train_state(sharded), tc, torch.from_numpy(tokens),
                               torch.from_numpy(seq_lens), mesh=mesh)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    whole = ttrain.TrainState(
        step=ts.step,
        params=ttrain.unshard_train_params(ts.params, tc, mesh, "cpu"),
        opt_state=ttrain.AdamState(ts.opt_state.count, ttrain.unshard_train_params(ts.opt_state.mu, tc, mesh, "cpu"),
                                   ttrain.unshard_train_params(ts.opt_state.nu, tc, mesh, "cpu")),
    )
    _compare_state(whole, js, f"{name} {mplan.describe()}", near_zero=_grads_near_zero(jp, jc, tokens, seq_lens))
    # the replicas of a weight stay equal to each other after the step
    for k, per in ts.params.items():
        spec = tllama.param_specs(tc)[k]
        for r in range(mesh.size):
            first = tmesh.replica_of(spec, mesh, r)
            assert torch.equal(per[r], per[first]), (k, r)


def test_a_doubled_gradient_would_fail_the_mesh_comparison():
    """The check above catches a double count: summing a shared tensor's
    gradient once more (what an all-reduce over ranks that share it
    would do) moves the step off the reference."""
    jc, jp, tc, tokens, seq_lens = _setup("tiny", seed=6, batch=4, seq=16)
    mesh = tmesh.make_mesh(tmesh.MeshPlan(dp=2, sp=2), ["cpu"] * 4)
    sharded = ttrain.shard_train_params(params_from_jax(_np(jp)), tc, mesh)
    real = ttrain.reduce_replica_grads

    def doubled(vtree, cfg, mesh):
        real(vtree, cfg, mesh)
        with torch.no_grad():
            for per in vtree.values():
                for leaf in {id(x): x for x in per}.values():
                    for v in (leaf if isinstance(leaf, list) else [leaf]):
                        v.grad = v.grad * 2

    ttrain.reduce_replica_grads = doubled
    try:
        ts, _ = ttrain.train_step(ttrain.make_train_state(sharded), tc, torch.from_numpy(tokens),
                                  torch.from_numpy(seq_lens), mesh=mesh)
    finally:
        ttrain.reduce_replica_grads = real
    opt = jtrain.make_optimizer()
    js, _ = jtrain.train_step(jtrain.make_train_state(jp, opt), jc, jnp.asarray(tokens), jnp.asarray(seq_lens), opt)
    whole = ttrain.unshard_train_params(ts.opt_state.mu, tc, mesh, "cpu")
    want = params_from_jax(_np(js.opt_state[0].mu))
    with pytest.raises(AssertionError):
        for k in want:
            _assert_close(whole[k], want[k], f"mu {k}")


def test_training_refuses_int8_and_pp():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), quantization="int8")
    with pytest.raises(ValueError, match="serving-time quantization"):
        ttrain.forward_train({}, cfg, torch.zeros((1, 4), dtype=torch.int32), torch.tensor([4]))
    # pp trains in one process (tests/test_torch_pp.py); a gang's pp mesh
    # stays refused, naming its item
    mesh = tmesh.make_mesh(tmesh.MeshPlan(pp=2), ["cpu", "cpu"])
    tc = tllama.LlamaConfig.tiny()
    sharded = ttrain.shard_train_params(
        {k: v.float() for k, v in tllama.init_params(tc, torch.Generator().manual_seed(0), "cpu").state_dict().items()},
        dataclasses.replace(tc, dtype=torch.float32), mesh,
    )
    assert [t.shape[0] for t in sharded["layers.wq"]] == [1, 1]
    with pytest.raises(NotImplementedError, match="item 15"):
        tmesh.make_mesh(tmesh.MeshPlan(pp=2), ["cpu"], group=object())

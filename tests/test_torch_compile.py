"""The port's compiled step (tpudl_torch.train.loop.compile_step, the
CUDA-graph counterpart of tpudl's ``compile_step``) and what a capture
needs, against tpudl on the CPU:

- ``compile_step`` on a CPU BERT_TINY state runs the step eagerly: bit
  for bit the eager step, and tpudl's ``compile_step`` on the same
  weights with dropout off (the bands of tests/test_torch_train.py);
- a step given generators seeded by ``step.seeds`` draws the eager
  step's bits (what a replay does), with dropout on;
- the optimizer's device count and device scalars give optax's update;
- the dense cache's device write index decodes LLAMA_TINY to tpudl's
  tokens and cache;
- the refusals.

The captures themselves run on the card (tests/test_torch_kernels_cuda.py
and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.config import OptimConfig as JOptimConfig
from tpudl.train import optim as joptim
from tpudl_torch.config import OptimConfig
from tpudl_torch.graphs import StaticInputs
from tpudl_torch.train import optim
from tpudl_torch.train.loop import (
    compile_step,
    create_train_state,
    make_classification_eval_step,
    make_classification_train_step,
)

_KEYS = ("input_ids", "attention_mask")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(n, batch=4, seq=16, vocab=30522, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = np.ones((batch, seq), np.int32)
        mask[1, seq // 2:] = 0
        out.append({
            "input_ids": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
            "attention_mask": mask,
            "label": rng.integers(0, 2, (batch,)).astype(np.int32),
        })
    return out


def _port_state(jparams, dropout=0.0):
    from tpudl_torch.models import bert

    cfg = bert.BERT_TINY(dtype=torch.float32, hidden_dropout=dropout,
                         attention_dropout=dropout)
    ocfg = OptimConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4,
                       schedule="linear")
    return create_train_state(
        0, bert.BertForSequenceClassification(cfg, "meta"),
        optim.make_optimizer(ocfg),
        params=bert.params_from_tpudl(jparams, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def tpudl_bert_tiny():
    from tpudl.models import bert as jbert
    from tpudl.train import create_train_state as jcreate

    jmodel = jbert.BertForSequenceClassification(jbert.BERT_TINY(
        dtype=jnp.float32, hidden_dropout=0.0, attention_dropout=0.0))
    jocfg = JOptimConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4,
                         schedule="linear")
    jstate = jcreate(jax.random.key(0), jmodel, jnp.zeros((1, 16), jnp.int32),
                     joptim.make_optimizer(jocfg))
    return jstate


def test_compile_step_on_a_cpu_state_is_the_eager_step_and_tpudls(
        tpudl_bert_tiny, one_thread):
    """Three steps: compile_step on a CPU state equals the eager step bit
    for bit (it runs it), and tpudl's compile_step on the same weights
    within tests/test_torch_train.py's bands (loss rtol 1e-4 / atol
    1e-5, parameters rtol 2e-3 / atol 2e-5)."""
    from tpudl.runtime.mesh import MeshSpec, make_mesh
    from tpudl.train import compile_step as jcompile
    from tpudl.train import make_classification_train_step as jstep
    from tpudl_torch.models import bert

    jstate = tpudl_bert_tiny
    jparams = jax.tree.map(np.asarray, jstate.params)
    eager, compiled = _port_state(jparams), _port_state(jparams)
    step = make_classification_train_step(input_keys=_KEYS)
    cstep = compile_step(step, compiled)
    mesh = make_mesh(MeshSpec(dp=1), jax.devices()[:1])
    jcompiled = jcompile(jstep(input_keys=_KEYS), mesh, jstate)
    for batch in _batches(3):
        eager, want = step(eager, batch, 1)
        compiled, got = cstep(compiled, batch, 1)
        jstate, jmetrics = jcompiled(jstate, batch, jax.random.key(1))
        assert torch.equal(got["loss"], want["loss"])
        np.testing.assert_allclose(float(got["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-4,
                                   atol=1e-5)
    assert compiled.step == eager.step == 3 and not cstep.captured
    assert int(compiled.opt_state["count"]) == 3
    mine = compiled.model.state_dict()
    for name, p in eager.model.state_dict().items():
        assert torch.equal(mine[name], p), name
    for name, w in bert.params_from_tpudl(jstate.params, device="cpu").items():
        np.testing.assert_allclose(mine[name].numpy(), w.numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=f"param {name}")


@pytest.mark.parametrize("accum", [1, 2])
def test_given_generators_draw_the_eager_steps_bits(tpudl_bert_tiny,
                                                    one_thread, accum):
    """A replay reseeds one persistent generator per microbatch with
    ``step.seeds(state, rng)``: the step given those generators is, bit
    for bit, the step that makes its own, with dropout 0.1, over three
    steps (each step reseeds)."""
    jparams = jax.tree.map(np.asarray, tpudl_bert_tiny.params)
    a, b = _port_state(jparams, 0.1), _port_state(jparams, 0.1)
    step = make_classification_train_step(input_keys=_KEYS,
                                          accum_steps=accum)
    gens = [torch.Generator() for _ in range(accum)]
    for batch in _batches(3, seed=1):
        for g, s in zip(gens, step.seeds(b, 7)):
            g.manual_seed(s)
        a, want = step(a, batch, 7)
        b, got = step(b, batch, 7, generators=gens)
        assert torch.equal(got["loss"], want["loss"])
    for (name, p), q in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(p, q), name
    # Dropout was on: another rng draws other masks.
    batch = _batches(1, seed=1)[0]
    _, seven = step(_port_state(jparams, 0.1), batch, 7)
    _, eight = step(_port_state(jparams, 0.1), batch, 8)
    assert not torch.equal(seven["loss"], eight["loss"])


_SHAPES = {"w": (7, 5), "b": (5,)}


@pytest.mark.parametrize("name", ["adamw", "sgd"])
@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_device_count_optimizer_matches_optax(name, schedule):
    """The count is a 0-d int64 tensor advanced in place, the step's
    scalars a device tensor filled from the host count before the update
    (``prepare_``), and the update in three halves gives optax's over
    three steps (rtol 1e-6, tests/test_torch_train.py's band), with its
    count readable as an int."""
    kw = dict(name=name, learning_rate=0.1, warmup_steps=1, total_steps=3,
              weight_decay=0.01, grad_clip_norm=1.0, schedule=schedule)
    jtx = joptim.make_optimizer(JOptimConfig(**kw))
    ttx = optim.make_optimizer(OptimConfig(**kw))
    rng = np.random.default_rng(4)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in _SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    count = tstate["count"]
    assert count.dtype == torch.int64 and count.dim() == 0
    jupdate = jax.jit(jtx.update)
    for i in range(3):
        g = {k: (0.5 * rng.normal(size=s)).astype(np.float32)
             for k, s in _SHAPES.items()}
        updates, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        ttx.prepare_(tstate)
        np.testing.assert_array_equal(
            tstate["scalars"].numpy(),
            np.float32(ttx.host_scalars(i)))
        ttx.update_(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                    tstate)
        ttx.advance_(tstate)
        for k in _SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i} param {k}")
    assert tstate["count"] is count and int(count) == 3
    assert tstate["host_count"] == 3


def test_device_write_index_decodes_llama_tiny_like_tpudl():
    """The serving engine's dense cache carries its write index as one 0-d
    device tensor that every layer shares: the decode writes its rows by
    ``index_copy_`` and advances the tensor in place. Three greedy decode
    steps after a left-padded prefill give tpudl's tokens, logits and
    whole cache (f32: rtol 1e-4 / atol 1e-5, tests/test_torch_llama.py's
    band)."""
    import importlib

    from tpudl.models import llama as jllama
    from tpudl_torch.models import llama as tllama

    jgen = importlib.import_module("tpudl.models.generate")
    tgen = importlib.import_module("tpudl_torch.models.generate")
    jmodel = jllama.LlamaForCausalLM(
        jllama.LLAMA_TINY(dtype=jnp.float32, max_seq_len=32))
    jparams = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = tllama.LlamaForCausalLM(
        tllama.LLAMA_TINY(dtype=torch.float32, max_seq_len=32), device="meta")
    tparams = tllama.params_from_tpudl(jparams, dtype=torch.float32,
                                       device="cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 512, size=(2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[1, :3] = 0
    ids[1, :3] = 0
    jlogits, jcache = jgen.prefill_fn(jmodel)(jparams, jnp.asarray(ids),
                                              jnp.asarray(mask))
    tlogits, tcache = tgen.prefill_fn(tmodel)(tparams, ids, mask)
    index = torch.tensor(int(tcache["model"]["layer_0"]["attention"]["index"]))
    for layer in tcache["model"].values():
        layer["attention"]["index"] = index
    position = mask.sum(-1).astype(np.int32)
    token = np.array(jnp.argmax(jlogits, -1), np.int32)
    decode = tgen.decode_fn(tmodel)
    for _ in range(3):
        jlogits, jcache = jgen.decode_fn(jmodel)(
            jparams, jcache, jnp.asarray(token), jnp.asarray(position))
        tlogits, tcache = decode(tparams, tcache, token, position)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-5)
        want = np.array(jnp.argmax(jlogits, -1), np.int32)
        np.testing.assert_array_equal(tlogits.argmax(-1).numpy(), want)
        token = want
        position = position + 1
    for name, layer in jcache["model"].items():
        t, j = tcache["model"][name]["attention"], layer["attention"]
        assert t["index"] is index and int(index) == int(j["index"]) == 11
        np.testing.assert_array_equal(t["valid"].numpy(),
                                      np.asarray(j["valid"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name}/{key}")


def test_compile_step_refusals(tpudl_bert_tiny):
    jparams = jax.tree.map(np.asarray, tpudl_bert_tiny.params)
    state = _port_state(jparams)
    step = make_classification_train_step(input_keys=_KEYS)
    for kw, item in ((dict(mesh=object()), "queue A item 7"),
                     (dict(rules=object()), "queue A item 7"),
                     (dict(steps_per_dispatch=2), "queue A item 10")):
        with pytest.raises(NotImplementedError, match=item):
            compile_step(step, state, **kw)
    # Precision policies are ported (tests/test_torch_precision.py): a
    # policy that carries state needs it on the train state.
    assert compile_step(step, state, precision="bf16").precision.name == "bf16"
    with pytest.raises(ValueError, match="loss-scale state"):
        compile_step(step, state, precision="fp8")
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        compile_step(step, state, steps_per_dispatch=0)
    with pytest.raises(ValueError, match="in place"):
        compile_step(step, state, donate_state=False)
    with pytest.raises(TypeError, match="seeds"):
        compile_step(lambda s, b, r: (s, {}), state)
    eval_step = compile_step(make_classification_eval_step(input_keys=_KEYS),
                             state, has_rng=False)
    assert eval_step.mask_aware
    with pytest.raises(ValueError, match="state it was compiled for"):
        compile_step(step, state)(_port_state(jparams), _batches(1)[0], 0)
    from tpudl_torch.models import bert

    def remat_state():
        return create_train_state(
            0, bert.BertForSequenceClassification(
                bert.BERT_TINY(dtype=torch.float32, remat="layer"), "meta"),
            state.tx, device="cpu")

    # A remat model compiles (its recomputes draw from twin generators
    # under capture); on the CPU the compiled step is the eager step.
    remat, twin = remat_state(), remat_state()
    compiled = compile_step(step, remat)
    assert compiled.remat
    batch = _batches(1)[0]
    _, got = compiled(remat, batch, 3)
    _, want = step(twin, batch, 3)
    assert torch.equal(got["loss"], want["loss"])
    for name, p in remat.params.items():
        assert torch.equal(p, twin.params[name]), name


def test_static_inputs_refuse_a_new_shape_naming_both():
    """What a replay does with a batch: copy it into the captured buffers,
    or raise naming the captured signature and the new one."""
    batch = _batches(1)[0]
    inputs = StaticInputs(batch, torch.device("cpu"))
    again = _batches(1, seed=5)[0]
    bufs = inputs.fill(again)
    for k, v in again.items():
        np.testing.assert_array_equal(bufs[k].numpy(), v)
    short = dict(again, input_ids=again["input_ids"][:, :8])
    with pytest.raises(ValueError,
                       match=r"input_ids: \[4, 16\] int32.*input_ids: \[4, 8\]"):
        inputs.fill(short)
    with pytest.raises(ValueError, match="float32"):
        inputs.fill(dict(again, label=again["label"].astype(np.float32)))
    with pytest.raises(ValueError, match="_valid"):
        inputs.fill(dict(again, _valid=np.ones(4, np.float32)))


def test_evaluate_pads_every_batch_for_a_compiled_step(tpudl_bert_tiny,
                                                      one_thread):
    """A compiled eval step replays one graph of one batch signature, so
    ``evaluate`` hands it every batch with a ``"_valid"`` column (the
    ragged tail padded); the metrics equal the eager step's."""
    from tpudl_torch.train.loop import evaluate

    jparams = jax.tree.map(np.asarray, tpudl_bert_tiny.params)
    state = _port_state(jparams)
    eval_step = make_classification_eval_step(input_keys=_KEYS)
    batches = _batches(3) + [{k: v[:3] for k, v in _batches(1, seed=9)[0].items()}]
    seen = []

    def spy(state, batch):
        seen.append(sorted(batch))
        return eval_step(state, batch)

    spy.mask_aware = True
    compiled = compile_step(spy, state, has_rng=False)
    got = evaluate(compiled, state, batches)
    want = evaluate(eval_step, state, batches)
    assert all(keys == sorted([*_KEYS, "label", "_valid"]) for keys in seen)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)

"""tpudl_torch.checkpoint and the resume helpers of tpudl_torch.train.loop
on the CPU (the counterpart of tests/test_checkpoint.py), the slice as a
whole against tpudl (BERT_TINY saved at step 4 of 8 and resumed, both
packages from the same weights), and the port's own bit-for-bit resumes:
BERT with dropout, a LoRA model with its frozen base, a state captured
by compile_step."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpudl_torch.checkpoint import (
    CheckpointManager,
    restore_train_state,
    save_train_state,
)
from tpudl_torch.config import OptimConfig, get_config
from tpudl_torch.data.synthetic import (
    synthetic_classification_batches,
    synthetic_token_batches,
)
from tpudl_torch.ft.data import ResumableIterator
from tpudl_torch.ft.manager import AsyncCheckpointManager
from tpudl_torch.ft.supervisor import resume_run
from tpudl_torch.models import bert
from tpudl_torch.models.resnet import ResNetTiny
from tpudl_torch.train import (
    compile_step,
    create_train_state,
    finalize_zero_step_run,
    fit,
    make_classification_train_step,
    make_optimizer,
    resume_latest,
)

_KEYS = ("input_ids", "attention_mask")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fresh_state(seed=0):
    """A ResNetTiny (tests/test_checkpoint.py's ResNet-18 cut to one block
    a stage) with AdamW."""
    model = ResNetTiny(num_classes=10, dtype=torch.float32, device="meta")
    tx = make_optimizer(OptimConfig(warmup_steps=0, schedule="constant",
                                    grad_clip_norm=None))
    return create_train_state(seed, model, tx, device="cpu")


def _batches(n):
    return list(synthetic_classification_batches(
        8, image_shape=(16, 16, 3), num_classes=10, num_batches=n))


def _tensors(state):
    out = dict(state.model.state_dict())
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": t for n, t in v.items()})
        elif k != "scalars":
            out[k] = torch.as_tensor(v)
    out["step"] = torch.tensor(state.step)
    return out


def _assert_bitwise(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


def test_save_restore_roundtrip(tmp_path):
    state = _fresh_state()
    step = make_classification_train_step()
    state, _ = step(state, _batches(1)[0], 0)
    path = str(tmp_path / "ckpt")
    save_train_state(path, state)
    fresh = _fresh_state(seed=1)
    restored = restore_train_state(path, fresh)
    assert restored is fresh and restored.step == 1
    _assert_bitwise(state, restored)
    with pytest.raises(FileExistsError):
        save_train_state(path, state, overwrite=False)
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "missing"), fresh)
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        restore_train_state(path, fresh, mesh="dp")


def test_resume_matches_uninterrupted_run(tmp_path):
    """train 5 -> save -> train 5 more == train 10 straight, bit for bit."""
    step = make_classification_train_step()
    batches = _batches(10)
    state_a = _fresh_state()
    losses_a = []
    for b in batches:
        state_a, m = step(state_a, b, 42)
        losses_a.append(float(m["loss"]))
    state_b = _fresh_state()
    for b in batches[:5]:
        state_b, _ = step(state_b, b, 42)
    path = str(tmp_path / "ckpt")
    save_train_state(path, state_b)
    state_c = restore_train_state(path, _fresh_state(seed=9))
    assert state_c.step == 5
    losses_c = []
    for b in batches[5:]:
        state_c, m = step(state_c, b, 42)
        losses_c.append(float(m["loss"]))
    assert losses_c == losses_a[5:]
    _assert_bitwise(state_a, state_c)


def test_save_train_state_crash_window_falls_back(tmp_path):
    """In the one crash window between the two renames the OLD
    checkpoint survives under the .tpudl-prev name and restore falls
    back to it; a later save cleans up and publishes normally."""
    state = _fresh_state()
    path = str(tmp_path / "ckpt")
    save_train_state(path, state)
    os.rename(path, path + ".tpudl-prev")
    with pytest.warns(UserWarning, match="crashed mid-publish"):
        restored = restore_train_state(path, _fresh_state(seed=3))
    _assert_bitwise(state, restored)
    os.makedirs(path + ".tpudl-staging")  # debris of a crashed save
    save_train_state(path, state)
    assert os.path.exists(path)
    assert not os.path.exists(path + ".tpudl-prev")
    assert not os.path.exists(path + ".tpudl-staging")


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_manager_retention_and_latest(tmp_path, async_save):
    state = _fresh_state()
    with CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2,
                           async_save=async_save) as mgr:
        for s in (1, 2, 3):
            state.step = s
            assert mgr.save(s, state)
        mgr.wait_until_finished()
        assert not mgr.save(3, state)  # already committed
        assert mgr.latest_step() == 3
        assert list(mgr.all_steps()) == [2, 3]
        restored = mgr.restore(_fresh_state(seed=3))
        assert restored.step == 3


def test_manager_restore_without_checkpoint_raises(tmp_path):
    with CheckpointManager(str(tmp_path / "empty")) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore(_fresh_state())


@pytest.mark.parametrize("async_save", [False, True])
def test_fit_periodic_checkpoint_and_resume_latest(tmp_path, async_save):
    """fit(checkpoint_manager=...) saves every N steps and at the end, and
    resume_latest restores the newest into a fresh state; with nothing
    left to train, finalize_zero_step_run saves warm-up steps taken
    outside fit."""
    step = make_classification_train_step()
    state = _fresh_state()
    with CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=5,
                           async_save=async_save) as mgr:
        state, start = resume_latest(mgr, state)
        assert start == 0
        state, _, info = fit(step, state, _batches(7), 0,
                             checkpoint_manager=mgr, checkpoint_every=3)
        assert mgr.all_steps() == [3, 6, 7] and not info["preempted"]
    with CheckpointManager(str(tmp_path / "ckpts"),
                           async_save=async_save) as mgr2:
        resumed, start = resume_latest(mgr2, _fresh_state(seed=3))
        assert start == 7 and resumed.step == 7
        _assert_bitwise(state, resumed)
        assert finalize_zero_step_run(mgr2, resumed, 0).startswith("no ")
        resumed, _ = step(resumed, _batches(1)[0], 0)  # a warm-up step
        assert "1 warmup" in finalize_zero_step_run(mgr2, resumed, 1)
        assert mgr2.latest_step() == 8


# ---------------------------------------------------------------------------
# BERT: the slice against tpudl, and the port's resumes with dropout
# ---------------------------------------------------------------------------


def _sst2_optim(**kw):
    return dataclasses.replace(get_config("sst2_bert_base").optim,
                               schedule="constant", warmup_steps=0, **kw)


def _token_batches(n, vocab):
    return list(synthetic_token_batches(8, 16, vocab, num_batches=n, seed=3))


def _port_run(params, cfg, batches, num_steps, mgr=None, every=0,
              resume=False, seed=0):
    """The port's run: a fresh state (``params``, or a fresh init from
    ``seed`` when resuming), resume_run when ``resume``, a compiled step,
    fit over a ResumableIterator. Returns (state, losses)."""
    model = bert.BertForSequenceClassification(cfg, device="meta")
    state = create_train_state(seed, model, make_optimizer(_sst2_optim()),
                               params=None if resume else params,
                               device="cpu")
    data, rng = ResumableIterator(batches), 1
    if resume:
        state, rng, data, start = resume_run(mgr, state, data)
        num_steps -= start
    losses = []
    step = compile_step(make_classification_train_step(input_keys=_KEYS,
                                                       loss_impl="auto"),
                        state)
    state, _, _ = fit(step, state, data, rng, num_steps=num_steps,
                      log_every=1, logger=lambda i, m: losses.append(m["loss"]),
                      checkpoint_manager=mgr, checkpoint_every=every)
    return state, losses


def test_bert_tiny_resume_matches_tpudl(tmp_path):
    """The slice as a whole: BERT_TINY (a vocabulary of 2048, dropout
    off) from the same weights (params_from_tpudl) over the same batches, the sst2_bert_base
    optimizer at a constant rate. tpudl's fit saves at step 4 of 8 and a
    fresh state resumes through tpudl's resume_run; the port's does the
    same through its own. The final parameters agree at
    tests/test_torch_train.py's bands (rtol 2e-3 / atol 2e-5), and the
    port's resumed run equals its own uninterrupted run bit for bit."""
    import jax
    import jax.numpy as jnp

    from tpudl.config import get_config as jget
    from tpudl.ft.data import ResumableIterator as JIter
    from tpudl.ft.manager import AsyncCheckpointManager as JManager
    from tpudl.ft.supervisor import resume_run as jresume_run
    from tpudl.models import bert as jbert
    from tpudl.train import create_train_state as jcreate
    from tpudl.train import fit as jfit
    from tpudl.train import make_classification_train_step as jstep
    from tpudl.train.optim import make_optimizer as jopt

    cfg = dict(hidden_dropout=0.0, attention_dropout=0.0, vocab_size=2048,
               max_position_embeddings=64)
    batches = _token_batches(8, 2048)
    jmodel = jbert.BertForSequenceClassification(
        jbert.BERT_TINY(dtype=jnp.float32, **cfg))
    jocfg = dataclasses.replace(jget("sst2_bert_base").optim,
                                schedule="constant", warmup_steps=0)

    def jstate(seed):
        return jcreate(jax.random.key(seed), jmodel,
                       jnp.zeros((1, 16), jnp.int32), jopt(jocfg))

    params = bert.params_from_tpudl(jstate(0).params, device="cpu")
    # One jitted step for both runs (one compile).
    step = jax.jit(jstep(input_keys=_KEYS))

    def jrun(state, data, rng, n, mgr):
        return jfit(step, state, data, rng, num_steps=n,
                    checkpoint_manager=mgr, checkpoint_every=4)[0]

    with JManager(str(tmp_path / "j")) as mgr:
        jrun(jstate(0), JIter(batches), jax.random.key(1), 4, mgr)
        assert mgr.latest_step() == 4
    with JManager(str(tmp_path / "j")) as mgr:
        state, rng, data, start = jresume_run(mgr, jstate(5), JIter(batches))
        assert start == 4
        jfinal = jrun(state, data, rng, 8 - start, mgr)
    assert int(jfinal.step) == 8

    tcfg = bert.BERT_TINY(dtype=torch.float32, fused_ops=True,
                          attention_impl="fused", **cfg)
    control, losses = _port_run(params, tcfg, batches, 8)
    with AsyncCheckpointManager(str(tmp_path / "t")) as mgr:
        _, head = _port_run(params, tcfg, batches, 4, mgr, every=4)
    with AsyncCheckpointManager(str(tmp_path / "t")) as mgr:
        resumed, tail = _port_run(params, tcfg, batches, 8, mgr, every=4,
                                  resume=True, seed=5)
    assert resumed.step == 8 and head + tail == losses
    _assert_bitwise(control, resumed)
    got = resumed.model.state_dict()
    for name, w in bert.params_from_tpudl(jfinal.params, device="cpu").items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=f"param {name}")


def test_bert_dropout_resume_bitwise(tmp_path):
    """The port alone with dropout 0.1 (hidden and attention, the fused
    slice's plain versions): the run saved at step 4 and resumed into a
    state initialised from another seed draws the same masks (each step's
    generators come from the saved seed and the restored step) and ends
    bit for bit where the uninterrupted run ends."""
    tcfg = bert.BERT_TINY(vocab_size=512, max_position_embeddings=32,
                          dtype=torch.float32, fused_ops=True,
                          attention_impl="fused")
    model = bert.BertForSequenceClassification(tcfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batches = _token_batches(8, 512)
    control, losses = _port_run(params, tcfg, batches, 8)
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        _, head = _port_run(params, tcfg, batches, 4, mgr, every=2)
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        resumed, tail = _port_run(params, tcfg, batches, 8, mgr, every=2,
                                  resume=True, seed=7)
        assert mgr.all_steps() == [4, 6, 8]
    assert head + tail == losses
    _assert_bitwise(control, resumed)


def test_lora_frozen_base_round_trips(tmp_path):
    """A LoRA classifier: the payload carries every parameter, the frozen
    base too (tpudl's payload holds the whole params tree), while the
    optimizer state covers the trainable ones. A state with another base
    restores to the saved base, and the resumed run equals the
    uninterrupted one bit for bit."""
    from tpudl_torch.models import llama
    from tpudl_torch.models.lora import lora_optimizer

    cfg = llama.LLAMA_TINY(dtype=torch.float32, num_labels=2, lora_rank=4,
                           vocab_size=128, max_seq_len=64)

    def state(seed):
        model = llama.LlamaForSequenceClassification(cfg, device="meta")
        tx = lora_optimizer(make_optimizer(OptimConfig(
            learning_rate=1e-2, warmup_steps=0, schedule="constant")),
            model, ("classifier",))
        return create_train_state(seed, model, tx, device="cpu")

    batches = list(synthetic_token_batches(4, 16, 128, num_batches=4, seed=2))
    step = make_classification_train_step(input_keys=_KEYS)
    control = state(0)
    base = {k: v.clone() for k, v in control.model.named_parameters()
            if not v.requires_grad}
    assert base and all(k not in control.opt_state["mu"] for k in base)
    for b in batches:
        control, _ = step(control, b, 3)
    half = state(0)
    for b in batches[:2]:
        half, _ = step(half, b, 3)
    with CheckpointManager(str(tmp_path / "ck"), async_save=True) as mgr:
        mgr.save(2, half)
        mgr.wait_until_finished()
        resumed = state(11)
        other = dict(resumed.model.named_parameters())
        assert not all(torch.equal(other[k], v) for k, v in base.items())
        mgr.restore(resumed)
    frozen = dict(resumed.model.named_parameters())
    for k, v in base.items():
        assert torch.equal(frozen[k], v), k
    for b in batches[2:]:
        resumed, _ = step(resumed, b, 3)
    _assert_bitwise(control, resumed)


def test_restore_into_a_compiled_state_keeps_its_tensors(tmp_path):
    """compile_step's graph holds the state's own tensors and refuses any
    other state: a restore writes into them (same objects, same storage)
    and the same compiled step trains on from the restored step to the
    uninterrupted run's end."""
    batches = _batches(6)
    step_fn = make_classification_train_step()
    control = _fresh_state()
    cstep = compile_step(step_fn, control)
    for b in batches:
        control, _ = cstep(control, b, 9)
    state = _fresh_state()
    compiled = compile_step(step_fn, state)
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        for b in batches[:3]:
            state, _ = compiled(state, b, 9)
        mgr.save(3, state, rng=9, data_state={"epoch": 0, "offset": 3})
        mgr.wait_until_finished()
        for b in batches[3:5]:  # steps the restore takes back
            state, _ = compiled(state, b, 9)
        ptrs = {k: v.data_ptr() for k, v in _tensors(state).items()
                if k not in ("step", "host_count")}
        objects = dict(state.model.named_parameters())
        restored, rng, data = mgr.restore_full(state)
    assert restored is state and state.step == 3 and rng == 9
    assert {k: v.data_ptr() for k, v in _tensors(state).items()
            if k in ptrs} == ptrs
    assert all(objects[k] is v for k, v in state.model.named_parameters())
    for b in batches[data["offset"]:]:
        state, _ = compiled(state, b, rng)
    _assert_bitwise(control, state)


# ---------------------------------------------------------------------------
# the precision leaf (mixed precision and fp8)
# ---------------------------------------------------------------------------

_FP8_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=16,
                num_labels=2)


def _fp8_state(seed=0, **cfg_kw):
    """BERT tiny (tests/test_precision.py's config) with fp8 sites,
    dropout on, under the "fp8" policy."""
    from tpudl_torch.train import policy

    cfg = policy("fp8").configure_model(bert.BertConfig(
        **dict(_FP8_CFG, **cfg_kw), fp8_train=True))
    model = bert.BertForSequenceClassification(cfg, device="meta")
    return create_train_state(seed, model, make_optimizer(_sst2_optim()),
                              device="cpu", precision="fp8")


def _precision_tensors(state):
    from tpudl_torch.ft.manager import flatten_with_keys

    return dict(flatten_with_keys({"precision": state.precision}))


def test_precision_leaf_cross_reads_with_tpudl(tmp_path):
    """The payload's ``precision`` leaf under tpudl's key names and
    dtypes: the port's store writes a trained fp8 state and tpudl's store
    reads its precision leaves (the keys, dtypes and shapes of tpudl's
    own fp8 payload, the port's values); tpudl's store writes tpudl's fp8
    payload and the port's store reads it, and its precision leaves copy
    into a port state (in place) key for key."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpudl.ft.manager import flatten_with_keys as jflatten
    from tpudl.ft.manager import state_payload as jpayload
    from tpudl.ft.store import CheckpointStore as JStore
    from tpudl.models.bert import BertConfig as JBertConfig
    from tpudl.models.bert import BertForSequenceClassification as JBert
    from tpudl.train import create_train_state as jcreate
    from tpudl.train import make_classification_train_step as jstep
    from tpudl_torch.ft.manager import host_leaves, state_payload
    from tpudl_torch.ft.store import CheckpointStore

    state = _fp8_state()
    step = make_classification_train_step(input_keys=_KEYS, precision="fp8")
    for b in _token_batches(2, 64):
        state, _ = step(state, b, 1)
    assert "precision" in state_payload(state)
    CheckpointStore(str(tmp_path / "t")).write(2, host_leaves(state))
    _, theirs = JStore(str(tmp_path / "t")).read(2)

    jcfg = JBertConfig(**_FP8_CFG, dtype=jnp.bfloat16, fp8_train="reference")
    jstate = jcreate(jax.random.key(0), JBert(jcfg),
                     jnp.zeros((1, 16), jnp.int32), optax.adamw(1e-3),
                     precision="fp8")
    jstate, _ = jax.jit(jstep(input_keys=_KEYS, precision="fp8"))(
        jstate, {k: jnp.asarray(v) for k, v in _token_batches(1, 64)[0].items()},
        jax.random.key(1))
    jleaves = {k: np.asarray(v) for k, v in jflatten(jpayload(jstate))
               if k.startswith("['precision']")}
    mine = _precision_tensors(state)
    # Six fp8 sites a composite layer, four leaves a site.
    assert set(mine) == set(jleaves) and len(mine) == 3 + 4 * 6 * 2
    for key, want in jleaves.items():
        got = theirs[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, mine[key].numpy(), err_msg=key)

    JStore(str(tmp_path / "j")).write(1, list(jleaves.items()))
    _, read = CheckpointStore(str(tmp_path / "j")).read(1)
    fresh = _fp8_state(seed=3)
    live = _precision_tensors(fresh)
    ptrs = {k: v.data_ptr() for k, v in live.items()}
    with torch.no_grad():
        for key, t in live.items():
            assert read[key].dtype == t.dtype, key
            t.copy_(read[key])
    for key, t in _precision_tensors(fresh).items():
        assert t.data_ptr() == ptrs[key]
        np.testing.assert_array_equal(t.numpy(), jleaves[key], err_msg=key)
    # A state without a policy writes no precision leaf.
    assert "precision" not in state_payload(_fresh_state())


@pytest.mark.parametrize("async_save", [False, True])
def test_fp8_run_resumes_bitwise(tmp_path, async_save):
    """tpudl's test_precision_state_resumes_schedule_identical on the
    port: an fp8 BERT tiny run with dropout saved at step 3 and restored
    into a state initialised from another seed continues bit for bit as
    the uninterrupted run (losses, parameters, optimizer state, rings and
    loss-scale state): the loss-scale schedule and every amax window
    round-trip, restored in place."""
    batches = _token_batches(6, 64)
    step = make_classification_train_step(input_keys=_KEYS, precision="fp8")
    control = _fp8_state(hidden_dropout=0.1, attention_dropout=0.1)
    losses = []
    for b in batches:
        control, m = step(control, b, 1)
        losses.append(float(m["loss"]))
    state = _fp8_state(hidden_dropout=0.1, attention_dropout=0.1)
    with CheckpointManager(str(tmp_path / f"ck{async_save}"),
                           async_save=async_save) as mgr:
        for b in batches[:3]:
            state, _ = step(state, b, 1)
        mgr.save(3, state)
        mgr.wait_until_finished()
        saved = {k: v.clone() for k, v in _precision_tensors(state).items()}
        fresh = _fp8_state(seed=5, hidden_dropout=0.1, attention_dropout=0.1)
        restored = mgr.restore(fresh, 3)
    assert restored is fresh and restored.step == 3
    for k, v in _precision_tensors(restored).items():
        assert torch.equal(v, saved[k]), k
    tail = []
    for b in batches[3:]:
        restored, m = step(restored, b, 1)
        tail.append(float(m["loss"]))
    assert tail == losses[3:]
    _assert_bitwise(control, restored)
    a, b = _precision_tensors(control), _precision_tensors(restored)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

"""Speculative decoding: draft k tokens cheap, verify them in one target
call (Leviathan et al., "Fast Inference from Transformers via
Speculative Decoding").

The port's counterpart of tpudl.serve.speculate. A cheap DRAFT path (by
default the int8 self-draft tpudl_torch.quant.quantize_model builds, or
any companion model sharing the tokenizer) proposes ``k`` tokens per
slot with k single-token paged calls; the target model scores the whole
window in ONE slot-batched chunk call
(tpudl_torch.models.generate.paged_chunk_decode_fn) and an acceptance
rule keeps the output distribution:

- **greedy** requests accept the longest prefix where the target's
  argmax agrees with the proposal; the first disagreement is REPLACED by
  the target's own choice, so the emitted stream is what non-speculative
  greedy decoding produces (up to near-tie flips between the chunked
  and single-token calls: the parity gate is ``assert_tokens_match``'s
  teacher-forced margin mode).
- **sampled** requests run acceptance sampling: proposal ``x ~ q`` is
  kept with probability ``min(1, p(x)/q(x))``; a rejection draws from
  the residual ``max(p - q, 0)`` and ends the window. Randomness is
  per-request counter-keyed (numpy Philox on ``(request.seed,
  token_index)``, tpudl's keys exactly), so a sampled request reproduces
  its tokens across runs; the stream differs from the non-speculative
  engine's ``fold_in`` stream.

Rollback is per-slot bookkeeping on the paged cache: the verify call
wrote the whole window into the slot's reserved pages, and a rejected
tail is abandoned by not advancing ``lens`` past the emitted count (the
rows past it are masked and overwritten by the next window).

Draft and target stay in LOCKSTEP: both caches see the same input
tokens at the same positions (the window is ``[t_last, p_1 ..
p_{k-1}]`` for both) and both advance ``lens`` by the emitted count. A
fully accepted window emits k tokens (no bonus token: the draft's cache
never saw ``p_k``).

The engine drives this through ``Engine._spec_step``; ``Speculator``
owns the draft calls and the draft's KV cache; the acceptance rules are
host functions. A migrated request takes its draft rows along
(``export_slot`` / ``import_slot``: a nested payload in the target's
format), so draft and target resume in lockstep.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

def _philox(seed: int, token_index: int, salt: int) -> np.random.Generator:
    """Counter-keyed per-(request, position) randomness: deterministic
    across runs and batch compositions, never reused across the
    (propose, accept, residual) roles (``salt``)."""
    return np.random.Generator(
        np.random.Philox(key=[
            ((seed & 0xFFFFFFFF) << 32) | (token_index & 0xFFFFFFFF),
            (salt << 16) | 0x5BEC,
        ])
    )


def softmax(logits: np.ndarray, temperature: float) -> np.ndarray:
    """Temperature-scaled softmax in f64 on the host (the acceptance
    ratio p/q is a ratio of tiny numbers; f32 underflow would bias
    it)."""
    x = np.asarray(logits, np.float64) / max(temperature, 1e-8)
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


def sample_from(probs: np.ndarray, u: float) -> int:
    """Inverse-CDF draw: the single-uniform sampling primitive both the
    draft proposal and the residual draw use."""
    cdf = np.cumsum(probs)
    return int(np.searchsorted(cdf, u * cdf[-1], side="right").clip(
        0, len(probs) - 1))


def greedy_accept(proposals: Sequence[int], target_choice: Sequence[int]
                  ) -> Tuple[List[int], int]:
    """Greedy acceptance: emit the target's choice at every position,
    stopping after the first one that disagrees with the proposal.
    Returns ``(emitted_tokens, accepted_count)``: the accepted prefix
    plus (on disagreement) the target's correction."""
    emitted: List[int] = []
    accepted = 0
    for p, t in zip(proposals, target_choice):
        emitted.append(int(t))
        if int(p) == int(t):
            accepted += 1
        else:
            break
    return emitted, accepted


def sample_accept(proposals: Sequence[int], q_probs: Sequence[np.ndarray],
                  p_probs: Sequence[np.ndarray], seed: int, token_index: int
                  ) -> Tuple[List[int], int]:
    """Leviathan acceptance sampling over one window: keep ``x ~ q`` with
    probability ``min(1, p(x)/q(x))``; on rejection draw from the
    normalized residual ``max(p - q, 0)`` and end the window; each
    emitted token is marginally distributed as ``p``. ``token_index`` is
    the absolute index of the window's first token in the request's
    stream (it keys the per-position Philox counters)."""
    emitted: List[int] = []
    accepted = 0
    for j, (x, q, p) in enumerate(zip(proposals, q_probs, p_probs)):
        x = int(x)
        u = float(_philox(seed, token_index + j, salt=2).random())
        qx, px = float(q[x]), float(p[x])
        if qx <= 0.0 or u * qx <= px:
            emitted.append(x)
            accepted += 1
            continue
        residual = np.maximum(np.asarray(p, np.float64) - q, 0.0)
        total = residual.sum()
        if total <= 0.0:
            # p <= q everywhere means p == q (both sum to 1): the
            # rejection was a numerical fluke; draw from p itself.
            residual, total = np.asarray(p, np.float64), 1.0
        r = float(_philox(seed, token_index + j, salt=3).random())
        emitted.append(sample_from(residual / total, r))
        break
    return emitted, accepted


class Speculator:
    """The draft half of speculative serving: a draft model (the int8
    self-draft, or a companion) with its OWN paged KV cache, kept in
    lockstep with the target engine's cache (same seat geometry, same fed
    tokens, same per-slot lens advance). The engine calls ``seat`` /
    ``propose`` / ``sync_len`` / ``free``. ``prefill_call`` and
    ``decode_call`` are the draft's prefill and paged decode contracts
    (CapturedCalls on the card)."""

    def __init__(self, prefill_call: Callable, decode_call: Callable,
                 params: Any, cache, k: int,
                 weight_bytes: Optional[int] = None):
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        self.prefill_call = prefill_call
        self.decode_call = decode_call
        self.params = params
        self.cache = cache  # a PagedKVCache (plain, pad-aligned seating)
        self.k = int(k)
        #: Resident draft weight bytes (weight_bytes_report's total).
        self.weight_bytes = weight_bytes

    # -- slot lifecycle (mirrors the target cache) ----------------------

    def seat(self, slot: int, input_ids, prompt_len: int,
             reserve_tokens: int) -> None:
        """Draft-prefill the request (left-padded batch-1, as the engine's
        own seat) and seat its draft KV row: the draft's own view of the
        prompt (its KV differs from the target's)."""
        ids = np.asarray(input_ids, np.int32)
        pad = prompt_len - ids.shape[0]
        padded = np.concatenate([np.zeros(pad, np.int32), ids])[None, :]
        mask = np.concatenate(
            [np.zeros(pad, np.int32), np.ones(ids.shape[0], np.int32)]
        )[None, :]
        # A captured prefill's row cache is its graph's buffer: seated
        # (copied into the pages) before the next prefill replays.
        _, row_cache = self.prefill_call(self.params, padded, mask)
        self.cache.seat(row_cache, slot, pad, prompt_len, reserve_tokens)

    def free(self, slot: int) -> None:
        self.cache.free(slot)

    def sync_len(self, slot: int, target_len_delta: int) -> None:
        """Advance the draft's lens by the emitted count (= the target's
        advance): the lockstep rollback, proposals past the accepted
        tail are never acknowledged."""
        self.cache.advance([slot], target_len_delta)

    # -- migration ------------------------------------------------------

    def export_slot(self, slot: int, input_ids, reserve_tokens: int) -> bytes:
        """This slot's draft KV as its own nested migration payload (the
        draft cache is a PagedKVCache: same pack and crc). The draft's
        rows differ from the target's (another model), so they ship as
        bytes. Non-destructive, like the cache's export."""
        meta = {
            "request": {"input_ids": [int(t) for t in input_ids]},
            "reserve_tokens": int(reserve_tokens),
        }
        return self.cache.export_request(slot, meta)

    def import_slot(self, slot: int, draft_payload) -> None:
        """Seat a nested draft payload into the draft cache at ``slot``:
        the draft is then back in lens-lockstep with the target's imported
        rows, and the next ``propose`` window runs as if the request never
        moved. Raises the cache's MigrationCorruptError /
        MigrationCompatError on a payload this draft cannot seat."""
        from tpudl_torch.serve.cache import parse_migration

        meta = (draft_payload if isinstance(draft_payload, dict)
                and "_arrays" in draft_payload
                else parse_migration(draft_payload))
        self.cache.import_request(meta, slot)

    # -- the propose loop ----------------------------------------------

    def propose(self, tokens0: np.ndarray, positions0: np.ndarray,
                active: Sequence[int], temps: np.ndarray, seeds: np.ndarray,
                token_index: np.ndarray):
        """k single-token draft calls from each slot's last emitted token.
        Greedy slots propose by argmax (a captured call's in-graph
        ``greedy``); sampling slots draw from the draft distribution with
        the per-(request, position) Philox stream, and their
        q-distributions come back for the acceptance test. Returns
        ``(proposals [B, k] int32, q_probs: {slot: [k arrays]} for
        sampling slots)``.

        The draft cache's lens advance here is PROVISIONAL (the k writes
        must land at successive positions); it is rolled back at the end
        and ``sync_len`` applies the emitted count."""
        b = tokens0.shape[0]
        k = self.k
        proposals = np.zeros((b, k), np.int32)
        sampling = [i for i in active if temps[i] > 0]
        q_probs = {i: [] for i in sampling}
        cur_tok = np.asarray(tokens0, np.int32).copy()
        cur_pos = np.asarray(positions0, np.int32).copy()
        lens_before = {i: int(self.cache.lens[i]) for i in active}
        for j in range(k):
            logits, self.cache.cache = self.decode_call(
                self.params, self.cache.cache, cur_tok, cur_pos,
                *self.cache.dispatch_args())
            greedy = getattr(self.decode_call, "greedy", None)
            if sampling:
                host = logits.float().cpu().numpy()
                sel = np.argmax(host, axis=-1).astype(np.int32)
                for i in sampling:
                    q = softmax(host[i], float(temps[i]))
                    u = float(_philox(int(seeds[i]), int(token_index[i]) + j,
                                      salt=1).random())
                    sel[i] = sample_from(q, u)
                    q_probs[i].append(q)
            else:
                from tpudl_torch.serve.engine import _select_greedy

                sel = _select_greedy(logits, greedy).astype(np.int32)
            self.cache.advance(active)
            proposals[:, j] = sel
            cur_tok = sel
            cur_pos = cur_pos + 1
        # Roll the provisional advance back; sync_len applies the
        # emitted count once the verdict is in.
        for i in active:
            self.cache.set_len(i, lens_before[i])
        return proposals, q_probs

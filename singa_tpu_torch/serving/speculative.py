"""Draft-model speculative decoding through the paged KV cache
(counterpart of singa_tpu/serving/speculative.py).

Each engine round runs

1. **propose**: a small DRAFT GPT decodes K tokens per slot through its
   OWN paged pools (same page table, same block geometry as the
   target's: one allocation covers both caches), as K+1 single-token
   micro-steps; each writes its K/V, then attends, and the extra step
   writes the last proposal's K/V so the draft cache never holes when
   every proposal is accepted;
2. **verify**: ONE fixed-slot pass of the TARGET scores all K+1
   positions of every active stream: the inputs ``[last_tok, d_1..d_K]``
   embed at positions ``pos..pos+K`` (position ids clamped at the
   window's last row), their K/V land through the page table in one
   window write (`layer.paged_kv_window_write`, overhang rows to the
   trash block), and query j attends the gathered cache masked to
   ``<= pos + j``: what K+1 sequential decode steps would attend;
3. **advance**: per-slot cursors move by the accepted prefix plus the
   correction token (host-side integers, nothing rebuilds).

On the card propose (K+1 micro-steps, the picks inside) and verify (the
pass and the acceptance) are each captured ONCE as a CUDA Graph over the
base engine's static inputs, and the round reads one (S, K+2) integer
block back. `decode_compiles` counts propose captures and
`verify_compiles` verify captures: 1 each across admits, evicts and
every acceptance pattern. On the CPU the same functions run uncaptured
and the counts count builds.

Acceptance runs on the device. Greedy streams accept the longest
prefix where the target's argmax equals the proposal, then emit the
target's own argmax, so every emitted token is the target's greedy
choice and the stream equals `generate(use_cache=True)` whatever the
draft (exactly on the CPU; on the card up to the rounding of products
of another batch width). Sampled streams use residual rejection:
proposal j is accepted with probability ``min(1, p(d_j)/q(d_j))`` and
the first rejection resamples from ``normalize(max(p - q, 0))``, which
preserves the target's distribution. Every draw is counter-based
noise keyed on (seed, domain, absolute position), with one domain each
for the draft's picks, the acceptance uniforms and the residual
resamples (`_DRAFT_FOLD`, `_ACCEPT_FOLD`, `_RESID_FOLD`), so a slot's
result never depends on its batch and sampled speculation is
deterministic per seed (it does not reproduce `generate`'s sampled
stream, and cannot equal the reference's, whose PRNG differs).

Rejected rows need no rollback: every future query masks to its own
horizon, and every round writes the range it attends before gathering.

On a tensor-parallel mesh (`mesh=`, `tp_axis=`; reference :132-199,
:457-680) the draft's pools and weights shard over the target's axis:
each rank's draft pools hold its d_heads/tp heads (a draft whose heads
the axis does not divide is refused), each propose micro-step runs the
draft's Megatron blocks with their two all-reduces a block and one
logits all-gather, and verify is the target's sharded window pass with
its own gather. A round is 2 x (L_target + L_draft x (K+1)) all-reduces
and K+2 gathers (the reference's `declared_schedule` census), still one
capture each of propose and verify; the picks and the acceptance run
on whole logits rows, the same on every rank. With a prefill mesh the
draft's full-window prefill runs beside the target's on the prefill
ranks and its caches travel with the target's.

Counters: ``spec_accepts`` / ``spec_rejects`` ride the process counter
registry; `acceptance_rate` is the engine's lifetime ratio, also the
``serve_acceptance_rate`` gauge when metrics are on.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from singa_tpu_torch.models.gpt import (
    fold_seed, gumbel_noise, pick_rows, uniform_noise)
from singa_tpu_torch.observability import metrics as obs_metrics
from singa_tpu_torch.resilience import counters
from singa_tpu_torch.serving.blocks import kv_block_bytes
from singa_tpu_torch.serving.engine import ServingEngine

__all__ = ["SpeculativeEngine"]

#: domain constants separating the three speculative random streams
#: (draft proposals, acceptance uniforms, residual resamples) from each
#: other and from the engine's per-index pick stream; each is then keyed
#: at the token's absolute position
_DRAFT_FOLD = 0x5bec_0001
_ACCEPT_FOLD = 0x5bec_0002
_RESID_FOLD = 0x5bec_0003


class SpeculativeEngine(ServingEngine):
    """A `ServingEngine` whose step is a draft-propose/target-verify
    round emitting 1..K+1 tokens per active stream.

    `draft_model` is any port GPT sharing the target's vocabulary;
    `spec_k` is the proposal depth (static: part of both captured
    graphs' shapes). Everything else (admission, paged blocks,
    eviction, refusals, `kv_dtype`: the draft pools store the same
    format) is the base engine's.
    """

    def __init__(self, model, draft_model, *, spec_k: int = 4, **kw):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if draft_model.vocab_size != model.vocab_size:
            raise ValueError(
                f"draft vocab {draft_model.vocab_size} != target vocab "
                f"{model.vocab_size}: the verify step scores the "
                "draft's token ids under the target head — the two "
                "models must share a vocabulary")
        self.spec_k = int(spec_k)
        self.draft_model = draft_model
        # draft dims BEFORE the base __init__: its `pool_bytes=` sizing
        # and the prefix fingerprint read them
        self.d_heads = draft_model.decoder.num_heads
        self._d_layers = draft_model.decoder.n_blocks
        self.d_model_draft = draft_model.d_model
        self.d_hd = self.d_model_draft // self.d_heads
        self.spec_rounds = 0
        self._accepted_tokens = 0
        self._proposed_tokens = 0
        self._acc_gauge = None
        self._draft_suffix = None
        super().__init__(model, **kw)

    def _extra_kv_block_bytes(self) -> int:
        """The draft pools' per-block bytes: they ride the same page
        table, so `pool_bytes=` sizing and the allocator's refusal math
        charge each block for both caches (per rank, like the target's,
        when the pools shard over a tp axis)."""
        return kv_block_bytes(self._d_layers, self.d_heads, self.d_hd,
                              self.block_size, self.kv_dtype, tp=self.tp)

    def _check_tp(self) -> None:
        if self.d_heads % self.tp:
            raise ValueError(
                f"SpeculativeEngine: draft has {self.d_heads} heads, not "
                f"divisible over tp={self.tp} — the draft pools shard on "
                f"the SAME axis as the target's (pick a draft head count "
                f"the mesh divides)")

    # -- the disaggregated prefill: the draft's caches travel too -----------

    def _init_draft(self) -> None:
        dm = self.draft_model
        if self.window > dm.pos.table.shape[0]:
            raise ValueError(
                f"window {self.window} exceeds the draft model's "
                f"max_len {dm.pos.table.shape[0]}")
        dm._ensure_initialized(self.window)
        self.dpv = dm._functional_params()
        self._draft_prefill = dm._decode_fns(self.window)[0]

    def _init_prefill_role(self) -> None:
        super()._init_prefill_role()
        self._init_draft()
        self._verify_builds = 0

    def _prefill_outputs(self, ctx, t0m1):
        lg, kvs = super()._prefill_outputs(ctx, t0m1)
        _, dkc, dvc = self._draft_prefill(self.dpv, ctx)
        return lg, kvs + [dkc, dvc]

    def _part_shapes(self, rows: int):
        dkv = ((self._d_layers, rows, self.d_heads // self._plan.tp,
                self.window, self.d_hd), self.dpv["tok"].dtype)
        return super()._part_shapes(rows) + [dkv, dkv]

    def _write_received(self, kvs, rows_d) -> None:
        super()._write_received(kvs, rows_d)
        self._draft_write_prefill(self.dkpools, self.dvpools, kvs[2],
                                  kvs[3], rows_d)

    def _fingerprint_extra(self) -> str:
        """A shared block carries DRAFT rows beside the target's, so the
        draft's dims are part of the content fingerprint: a plain engine
        (or one with another draft) never matches a speculative block."""
        return (f":draft(d{self.d_model_draft}:h{self.d_heads}"
                f":L{self._d_layers}:k{self.spec_k})")

    def _cow_pools(self) -> List[torch.Tensor]:
        return super()._cow_pools() + [
            t for t in (self._dkdata, self._dvdata, self._dkscale,
                        self._dvscale) if t is not None]

    # -- observability -----------------------------------------------------

    @property
    def verify_compiles(self) -> int:
        """Verify captures on the card (builds on the CPU): exactly 1
        across any admit/evict/acceptance interleaving. (`decode_
        compiles` counts the propose graph's.)"""
        return self._verify_builds

    @property
    def acceptance_rate(self) -> float:
        """Accepted draft tokens over proposed draft tokens, engine
        lifetime (1.0 = every proposal accepted)."""
        return self._accepted_tokens / max(1, self._proposed_tokens)

    # -- the round: draft cache, propose and verify, built once -------------

    def _build_step(self) -> None:
        """The base constructor's last act. This engine's step is the
        propose + verify round: allocate the draft pools on the same
        blocks, then build (on the card: capture) propose and verify
        once each over the base engine's static inputs."""
        self._init_draft()
        #: the draft's heads on this rank, and the parameters its
        #: micro-steps run (its blocks of the weights on a tp mesh)
        self._dhl = self.d_heads // self.tp
        self._d_step_pv = (self.dpv if self.mesh is None
                           else self._shard_params(self.dpv))
        nb = self.allocator.num_blocks
        args = (self._d_layers, nb, self.block_size, self._dhl,
                self.d_hd, self.device)
        self._dkdata, self._dkscale, self.dkpools = self._kv.make_pools(*args)
        self._dvdata, self._dvscale, self.dvpools = self._kv.make_pools(*args)
        # the allocator's informational bytes/block states the true cost
        self.allocator.bytes_per_block += self._extra_kv_block_bytes()
        self._draft_write_prefill = self._build_write_prefill(
            self._dhl, self.d_hd)
        self._propose = self._build_propose(self._build_decode_forward(
            self._dhl, self.d_hd, scope=self._d_step_pv))
        self._verify = self._build_verify()

        self._decode_builds = self._verify_builds = 1
        self._propose_graph = self._verify_graph = None
        if self.device.type != "cuda":
            return
        self._propose_graph, self._propose_out = self._capture(
            self._propose_fn)
        # verify reads propose's static outputs: fill them with real
        # (in-vocab) proposals before verify's warm-ups run
        self._propose_graph.replay()
        self._verify_graph, self._verify_out = self._capture(
            lambda: self._verify_fn(*self._propose_out))

    # -- shardlint's surface (reference :268-330) --------------------------

    def declared_schedule(self, mesh) -> Dict:
        """The round's declared collectives: per block, the verify pass's
        two Megatron all-reduces (the target's blocks); over the whole
        round, the draft's two a block in each of its K+1 micro-steps
        beside them, and one logits all-gather a micro-step plus
        verify's."""
        from singa_tpu_torch.parallel import tp as tp_module

        ax = self.tp_axis
        if ax is None or mesh is None or ax not in mesh.shape:
            return {"n_blocks": self._n_layers, "per_block": {}}
        lt, ld, kp1 = self._n_layers, self._d_layers, self.spec_k + 1
        g = tp_module.LOGITS_GATHERS_PER_STEP
        return {
            "n_blocks": lt,
            "per_block": {("psum", ax): tp_module.PSUMS_PER_BLOCK},
            "census": {
                ("psum", ax): tp_module.PSUMS_PER_BLOCK * (lt + ld * kp1),
                ("all_gather", ax): g * (kp1 + 1),
            },
        }

    def _lint_step(self):
        """One uncaptured propose + verify round."""
        return self._verify_fn(*self._propose_fn())

    def _lint_replay(self) -> None:
        if self._verify_graph is None:
            self._lint_step()
        else:
            self._propose_graph.replay()
            self._verify_graph.replay()

    def _propose_fn(self):
        """Propose over the static inputs: (dtoks (S, K), dlogits
        (S, K, V))."""
        pt, tok, pos, seeds, _, sample, temps = self._step_inputs()
        return self._propose(self._d_step_pv, self.dkpools, self.dvpools,
                             pt, tok, pos, seeds, temps, sample)

    def _verify_fn(self, dtoks, dlogits):
        """Verify over the static inputs and propose's output: one
        (S, K+2) block, the emitted row then n_acc."""
        pt, tok, pos, seeds, _, sample, temps = self._step_inputs()
        return self._verify(self._step_pv, self.kpools, self.vpools, pt,
                            tok, dtoks, dlogits, pos, seeds, temps, sample)

    def _run_propose(self):
        if self._propose_graph is None:
            return self._propose_fn()
        self._propose_graph.replay()
        return self._propose_out

    def _run_verify(self, proposed):
        if self._verify_graph is None:
            return self._verify_fn(*proposed)
        self._verify_graph.replay()
        return self._verify_out

    def _build_propose(self, forward):
        """K+1 draft micro-steps. Micro-step i feeds token x_i (x_0 =
        last_tok, x_i = d_i) at position pos+i, WRITING its K/V before
        attending, so the draft cache holds every input token, d_K
        included (the extra step exists for that write; its pick is
        discarded). Greedy slots propose the draft's argmax; sampled
        slots draw from the draft's distribution at the position-keyed
        draft stream. `forward` is the base engine's decode forward at
        the draft's dims."""
        K = self.spec_k

        def propose(dpv, dkpools, dvpools, page_table, tok0, pos, seeds,
                    temps, sample):
            dseeds = fold_seed(seeds, _DRAFT_FOLD)
            tok, toks, logits = tok0, [], []
            for i in range(K + 1):
                lg = forward(dpv, dkpools, dvpools, page_table, tok,
                             pos + i)
                tok = pick_rows(lg, dseeds, pos + i, temps, sample)
                toks.append(tok)
                logits.append(lg)
            return torch.stack(toks[:K], 1), torch.stack(logits[:K], 1)

        return propose

    def _build_verify(self):
        """The target scores all K+1 positions of every slot in one pass
        (`_build_window_forward` at width K+1, anchored at each slot's
        cursor: the decode step's einsums, masking and fp32 LayerNorm
        with a query dim), then `_accept` on the device."""
        K = self.spec_k
        forward = self._build_window_forward(K + 1)

        def verify(pv, kpools, vpools, page_table, tok0, dtoks, dlogits,
                   pos, seeds, temps, sample):
            toks_in = torch.cat([tok0[:, None], dtoks], dim=1)
            logits = forward(pv, kpools, vpools, page_table, toks_in, pos)
            emit, n_acc = _accept(logits, dtoks, dlogits, pos, seeds,
                                  temps, sample, K)
            return torch.cat([emit, n_acc[:, None]], dim=1)

        return verify

    # -- admission: the draft cache prefills beside the target's -----------

    def _ensure_suffix(self) -> None:
        """Warm and chunked admissions run the suffix schedule for BOTH
        caches: the draft's headless suffix twin comes with the
        target's."""
        super()._ensure_suffix()
        if self._draft_suffix is None:
            self._draft_suffix = self._build_suffix_prefill(
                with_logits=False, heads=self._dhl, hd=self.d_hd)

    def _prefill_extra(self, ctx, rows) -> None:
        _, kc, vc = self._draft_prefill(self.dpv, ctx)
        if self.tp_axis is not None:
            kc, vc = self._local_heads(kc), self._local_heads(vc)
        self._draft_write_prefill(self.dkpools, self.dvpools, kc, vc, rows)

    def _suffix_extra(self, toks, start, rows) -> None:
        """Each suffix chunk also runs through the draft-dim suffix
        (headless: only its K/V writes matter; captured per batch width
        on the card), so the draft cache holds what a cold full-window
        draft prefill would have written for the same rows."""
        self._replay(("draft_suffix", toks.shape[0]),
                     lambda *a: self._draft_suffix(
                         self._d_step_pv, self.dkpools, self.dvpools, *a),
                     (rows, toks, start))

    # -- the speculative decode round --------------------------------------

    def step(self) -> Dict[object, List[int]]:
        """One propose + verify round; returns {rid: [tokens]}. Every
        active stream advances by 1..K+1 tokens (at least 1: the
        correction or bonus token is the target's own pick, so a fully
        rejected round is a plain decode step). Finished requests are
        evicted after their last token; a stream never emits past its
        max_new (surplus accepted proposals at its very end are dropped
        with their masked, later rewritten, cache rows)."""
        if not self.active.any():
            return {}
        rec = obs_metrics.enabled()
        t0 = time.perf_counter() if rec else 0.0
        if self.prefix_cache:
            # the round writes K+1 rows per slot (propose's micro-steps
            # and verify's window write)
            self._cow_guard(self.spec_k + 1)
        with torch.inference_mode():
            self._upload()
            out = self._run_verify(self._run_propose()).cpu().numpy()
        emit, n_acc = out[:, :-1], out[:, -1]
        self.steps += 1
        self.spec_rounds += 1

        idx = np.flatnonzero(self.active)
        remaining = np.array([self._reqs[int(s)].max_new for s in idx],
                             np.int32) - self.n_gen[idx]
        m = np.minimum(n_acc[idx] + 1, remaining)   # tokens to emit
        accepted = int(n_acc[idx].sum())
        proposed = int(idx.size * self.spec_k)
        self._accepted_tokens += accepted
        self._proposed_tokens += proposed
        counters.bump("spec_accepts", accepted)
        counters.bump("spec_rejects", proposed - accepted)

        self._advance_slots(idx, emit[idx, m - 1], m)
        emitted: Dict[object, List[int]] = {}
        for j, slot in enumerate(idx):
            slot = int(slot)
            req = self._reqs[slot]
            toks = [int(t) for t in emit[slot, :m[j]]]
            emitted[req.rid] = toks
            done = int(self.n_gen[slot]) >= req.max_new
            for t_i, t in enumerate(toks):
                req._emit(t, done and t_i == len(toks) - 1)
            if done:
                self.evict(slot)
        if self.prefix_cache:
            # after the emit loop: req.tokens holds the round's tokens,
            # so newly completed blocks hash correctly in BOTH caches
            self._register_decoded(idx)
        if rec:
            self._record_step_metrics(time.perf_counter() - t0,
                                      int(idx.size), int(m.sum()))
            if self._acc_gauge is None:
                self._acc_gauge = obs_metrics.gauge(
                    "serve_acceptance_rate")
            self._acc_gauge.set(self.acceptance_rate)
        return emitted


# -- device-side acceptance ---------------------------------------------------


def _accept(logits, dtoks, dlogits, pos, seeds, temps, sample, K):
    """Acceptance and correction for one verify pass, fixed shapes, no
    host sync. logits (S, K+1, V) of the target, dtoks (S, K) and
    dlogits (S, K, V) of the draft.

    Greedy: n_acc = the longest prefix with target argmax == proposal;
    the emitted row is [d_1..d_{n_acc}, argmax_{n_acc}], every entry a
    target argmax. Sampled: residual rejection (accept j iff
    u_j q_j(d_j) < p_j(d_j), the first rejection resampled from
    normalize(max(p - q, 0)), full acceptance bonus-sampled from
    p_K). Entries past index n_acc are garbage the host never emits.
    Returns (emit (S, K+1), n_acc (S,)), int64."""
    s = dtoks.shape[0]
    dev = dtoks.device
    rows = torch.arange(s, device=dev)
    lg = logits.float()                               # (S, K+1, V)
    tgt = lg.argmax(dim=-1)                           # (S, K+1)

    # greedy prefix acceptance
    match = (tgt[:, :K] == dtoks).long()
    n_acc_g = match.cumprod(dim=1).sum(dim=1)

    # residual rejection acceptance
    t3 = temps[:, None, None]
    p = torch.softmax(lg[:, :K] / t3, dim=-1)         # (S, K, V)
    q = torch.softmax(dlogits.float() / t3, dim=-1)
    pd = p.gather(-1, dtoks[..., None])[..., 0]
    qd = q.gather(-1, dtoks[..., None])[..., 0]
    posj = pos[:, None] + torch.arange(K, device=dev)[None, :]
    u = uniform_noise(fold_seed(seeds, _ACCEPT_FOLD), posj)   # (S, K)
    acc = (u * qd.clamp(min=1e-30) < pd).long()
    n_acc_s = acc.cumprod(dim=1).sum(dim=1)

    n_acc = torch.where(sample, n_acc_s, n_acc_g)

    # the correction token at index r = n_acc: a residual resample
    # (r < K) or a bonus sample from the target's K-th row (r == K)
    r = n_acc
    pr = torch.softmax(lg[rows, r] / temps[:, None], dim=-1)  # (S, V)
    qr = q[rows, r.clamp(max=K - 1)]
    resid = (pr - torch.where((r < K)[:, None], qr,
                              torch.zeros_like(qr))).clamp(min=0.0)
    z = resid.sum(dim=-1, keepdim=True)
    probs = torch.where(z > 1e-30, resid / z.clamp(min=1e-30), pr)
    noise = gumbel_noise(fold_seed(seeds, _RESID_FOLD), pos + r,
                         probs.shape[-1])
    corr_s = (torch.log(probs + 1e-30) + noise).argmax(dim=-1)
    corr = torch.where(sample, corr_s, tgt[rows, r])

    draft_row = torch.cat([dtoks, torch.zeros_like(dtoks[:, :1])], dim=1)
    j = torch.arange(K + 1, device=dev)[None, :]
    emit = torch.where(j < n_acc[:, None], draft_row,
                       torch.where(j == n_acc[:, None], corr[:, None],
                                   torch.zeros_like(draft_row)))
    return emit, n_acc

"""Streaming GPT serving (counterpart of examples/serve_gpt.py).

Builds a GPT with seeded random weights (a small char-level one, or
`gpt_medium` with --gpt-medium) and serves --requests prompts through
the streaming `Frontend` over the continuous-batching `ServingEngine`:
requests are admitted as slots free, every step advances all live
streams, each token streams through its callback, and a SIGTERM
mid-serve drains the streams in flight (--drain-budget bounds the
extra tokens; --exit-on-preempt exits 0 after). Runs on the card unless
`--device cpu`:

    python -m singa_tpu_torch.examples.serve_gpt --requests 6 --slots 2
    python -m singa_tpu_torch.examples.serve_gpt --device cpu \\
        --requests 6 --draft tiny --sched chunked --replicas 2 \\
        --prefix-cache

--kv-dtype picks the pool format; --prefix-cache shares a common
"system prompt" (--shared-prompt tokens, default two blocks) across
requests; --draft self|tiny serves speculatively (--spec-k proposals a
round; "tiny" is a seeded `gpt_draft`, "self" the model itself);
--overlap-prefill dispatches prefill between decode steps; --sched
chunked prefills in --chunk-budget block-wide chunks a step boundary,
with --priority and --tenant labels cycled over the requests for its
lanes and per-tenant fairness; --replicas N puts N engines (one model,
a pool and graphs each) behind one `ReplicaRouter` queue
(--router-affinity off: load and round-robin only). Every greedy stream
equals a solo `generate(use_cache=True)` of the same prompt. The
reference's tensor-parallel and metrics-endpoint flags raise, naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from singa_tpu_torch import device as device_module
from singa_tpu_torch.model import load_singa_tpu_params
from singa_tpu_torch.models.gpt import GPT, gpt_draft, gpt_medium
from singa_tpu_torch.observability import metrics
from singa_tpu_torch.serving import (
    ChunkedScheduler, Frontend, ReplicaRouter, ServingEngine,
    SpeculativeEngine)

_BUILTIN = (
    "the engine admits a request, pages its cache, and streams the "
    "tokens back one captured step at a time. "
    "long prompts and short prompts share the pool, block by block. "
) * 30


def seeded_weights(model, seed):
    """Random weights for every parameter, from numpy with `seed`, at
    the scales of the reference's initialisers. The scanned decoder
    stacks its blocks' parameters on a leading axis (`decoder.<name>`),
    so a (L, n) bias or LayerNorm offset is a vector, not a matrix."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        stacked = name.startswith("decoder.") and name.count(".") == 1
        per_block = shape[1:] if stacked else shape
        if name.endswith(".table"):
            a = 0.1 * rng.standard_normal(shape, dtype=np.float32)
        elif name.endswith(("ln1_s", "ln2_s", "scale")):
            a = 1.0 + 0.05 * rng.standard_normal(shape, dtype=np.float32)
        elif len(per_block) >= 2:
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(shape[-2] ** -0.5)
        else:
            a = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        out[name] = a
    return out


def run(args):
    if args.tp > 1:
        raise NotImplementedError(
            "--tp is not ported yet (ROADMAP queue 1 items 10 (tp "
            "decode) and 14 (parallel/tp.py))")
    if args.metrics_port is not None:
        raise NotImplementedError(
            "--metrics-port is not ported yet (ROADMAP queue 1 item 18 "
            "(the exporters))")
    dev = device_module.resolve(args.device)
    if args.gpt_medium:
        m = gpt_medium(device=dev)
        ids = np.random.default_rng(args.seed).integers(
            0, m.vocab_size, 4096)
        chars = None
    else:
        chars = sorted(set(_BUILTIN))
        c2i = {c: i for i, c in enumerate(chars)}
        ids = np.array([c2i[c] for c in _BUILTIN], np.int64)
        m = GPT(vocab_size=len(chars), d_model=args.d_model,
                num_layers=args.layers, num_heads=args.heads,
                max_len=args.window, dropout=0.0, scan_blocks=True,
                device=dev)
    load_singa_tpu_params(m, seeded_weights(m, args.seed))
    m.eval()

    ekw = dict(slots=args.slots, block_size=args.block_size,
               window=args.window, num_blocks=args.num_blocks,
               prefill_batch=args.prefill_batch, kv_dtype=args.kv_dtype,
               prefix_cache=args.prefix_cache)
    draft = None
    if args.draft == "tiny":
        # an untrained draft: acceptance ~0, the same tokens (draft
        # quality is a speed knob, never a correctness one)
        draft = gpt_draft(m)
        load_singa_tpu_params(draft, seeded_weights(draft, args.seed + 1))
        draft.eval()

    def mk_engine():
        if args.draft == "none":
            return ServingEngine(m, **ekw)
        return SpeculativeEngine(m, m if args.draft == "self" else draft,
                                 spec_k=args.spec_k, **ekw)

    # --replicas N: N engines behind ONE router queue; they share the
    # model (each owns its pool and captured graphs), and with --sched
    # chunked every replica's scheduler charges one tenant ledger
    engines = [mk_engine() for _ in range(max(1, args.replicas))]
    engine = engines[0]
    router = sched = None
    if args.replicas > 1:
        router = fe = ReplicaRouter(
            engines, affinity=args.router_affinity == "on",
            drain_token_budget=args.drain_budget,
            sched="chunked" if args.sched == "chunked" else None,
            chunk_budget=args.chunk_budget)
    else:
        sched = (ChunkedScheduler(chunk_budget=args.chunk_budget)
                 if args.sched == "chunked" else None)
        fe = Frontend(engine, drain_token_budget=args.drain_budget,
                      overlap_prefill=args.overlap_prefill, sched=sched)
    print(f"engine on {dev}: {args.slots} slots, "
          f"{engine.allocator.capacity} blocks x {args.block_size} tokens "
          f"({engine.allocator.bytes_per_block} bytes/block, "
          f"kv_dtype={args.kv_dtype}, pool {engine.pool_bytes} bytes"
          + (f", draft={args.draft} k={args.spec_k}"
             if args.draft != "none" else "")
          + (f"; {len(engines)} replicas" if router is not None else "")
          + ")")

    rng = np.random.default_rng(args.seed + 1)
    n_shared = (args.shared_prompt if args.shared_prompt is not None
                else (2 * args.block_size if args.prefix_cache else 0))
    sys_prompt = ids[:n_shared]
    max_t0 = args.window - args.max_new - len(sys_prompt)
    if max_t0 < 5:
        raise SystemExit(
            f"--window {args.window} leaves {max_t0} tokens for the "
            f"per-request prompt after max_new and the shared prefix; "
            f"raise --window or lower --max-new")
    # lane and tenant labels cycle over the submit order; only the
    # chunked scheduler reads them (the default loop serves FIFO)
    prios = [p.strip() for p in args.priority.split(",")
             if p.strip()] or ["normal"]
    tenants = ([t.strip() for t in args.tenant.split(",") if t.strip()]
               if args.tenant else [None])

    def show(tok):
        return repr(chars[tok]) if chars is not None else str(tok)

    handles = []
    for r in range(args.requests):
        t0 = int(rng.integers(4, max_t0))
        start = int(rng.integers(0, len(ids) - t0))
        prompt = np.concatenate([sys_prompt, ids[start:start + t0]])

        def cb(tok, done, r=r):
            print(f"  [req {r}] {show(tok)}{'  <done>' if done else ''}")

        handles.append(fe.submit(
            prompt.astype(np.int32), args.max_new,
            temperature=args.temperature, seed=args.seed + r,
            on_token=cb if args.echo else None,
            priority=prios[r % len(prios)],
            tenant=tenants[r % len(tenants)]))

    metrics.reset()
    metrics.enable()
    t = time.perf_counter()
    try:
        report = fe.run(exit_on_preempt=args.exit_on_preempt)
    except SystemExit:
        done = sum(1 for h in handles if h.status == "done")
        print(f"preempted: drained {done} in-flight/completed streams "
              f"({sum(e.tokens_emitted for e in engines)} tokens "
              f"emitted), "
              f"{sum(1 for h in handles if h.status == 'preempted')} "
              f"requests handed back unstarted; exit 0")
        raise
    finally:
        metrics.disable()
        if router is not None:
            router.close()
    wall = time.perf_counter() - t
    hist = metrics.histogram("serve_token_ms")

    done = sum(1 for h in handles if h.status == "done")
    n_tok = sum(e.tokens_emitted for e in engines)
    for h in handles:
        text = ("".join(chars[i] for i in h.tokens) if chars is not None
                else " ".join(map(str, h.tokens[:16])))
        prompt = h.prompt if router is not None else h.request.prompt
        print(f"req {h.rid} [{h.status}]: prompt {len(prompt)} "
              f"tokens -> {text!r}")
    print(f"served {done}/{args.requests} requests, {n_tok} tokens in "
          f"{wall:.3f} s ({n_tok / wall:.1f} tokens/s aggregate on {dev}), "
          f"{sum(e.steps for e in engines)} steps; per-token p50 "
          f"{hist.percentile(0.5):.3f} ms, p95 {hist.percentile(0.95):.3f}"
          f" ms")
    kind = "CUDA Graph captures" if dev.type == "cuda" else "builds"
    print(f"decode executables: "
          f"{','.join(str(e.decode_compiles) for e in engines)} ({kind})")
    if router is not None:
        st = router.stats
        hz = router.healthz()
        per = ", ".join(f"{rep.name}={rep.backend.engine.tokens_emitted}"
                        for rep in router.replicas)
        print(f"router: {len(engines)} replicas ({hz['live']} live, "
              f"quorum {hz['quorum']}), {st['dispatches']} dispatches, "
              f"{st['affinity_hits']} affinity hits, "
              f"{st['rebalances']} rebalances, "
              f"{st['replica_deaths']} deaths, "
              f"{st['requeued']} requeued; tokens per replica: {per}")
        if args.sched == "chunked":
            scheds = [rep.backend.sched for rep in router.replicas]
            picks = {}
            for sc in scheds:
                for k, v in sc.lane_picks.items():
                    picks[k] = picks.get(k, 0) + v
            print(f"sched: chunked fleet-wide (budget "
                  f"{args.chunk_budget}), lane picks "
                  + ", ".join(f"{k}={v}" for k, v in picks.items())
                  + f", shared-ledger tenant deficit "
                  f"{scheds[0].tenant_deficit()} tokens")
    if args.draft != "none":
        for i, e in enumerate(engines):
            tag = f" [r{i}]" if len(engines) > 1 else ""
            print(f"speculative{tag}: {e.spec_rounds} rounds, "
                  f"acceptance {e.acceptance_rate:.2f}, "
                  f"verify executables: {e.verify_compiles} ({kind})")
    if sched is not None:
        picks = ", ".join(f"{k}={v}" for k, v in sched.lane_picks.items())
        print(f"sched: chunked (budget {args.chunk_budget}), lane picks "
              f"{picks}, tenant deficit {sched.tenant_deficit()} tokens")
    if args.prefix_cache:
        sts = [e.prefix_stats for e in engines]
        tot = {k: sum(st[k] for st in sts)
               for k in ("hits", "misses", "shared_pages",
                         "cached_blocks", "cow_copies")}
        print(f"prefix cache: {tot['hits']} hits / {tot['misses']} "
              f"misses, {tot['shared_pages']} shared pages, "
              f"{tot['cached_blocks']} cached blocks, "
              f"{tot['cow_copies']} cow copies, suffix executables: "
              f"{sum(e.prefix_prefill_compiles for e in engines)}")
    if report["drained"]:
        print(f"preempted: drained {report['drain_tokens']} in-flight "
              f"tokens, {len(report['preempted'])} requests returned "
              f"unstarted")
    return handles


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--gpt-medium", action="store_true",
                   help="serve gpt_medium (vocab 32768, d 1024, 12 blocks)")
    p.add_argument("--d-model", type=int, default=96)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--window", type=int, default=64,
                   help="per-request cache length (prompt + max_new)")
    p.add_argument("--slots", type=int, default=2,
                   help="decode batch width")
    p.add_argument("--block-size", type=int, default=16,
                   help="KV-cache block rows")
    p.add_argument("--num-blocks", type=int, default=None,
                   help="pool blocks (default: every slot at full window)")
    p.add_argument("--prefill-batch", type=int, default=1)
    p.add_argument("--kv-dtype", choices=("fp32", "bf16", "int8"),
                   default="fp32", help="KV pool storage format")
    p.add_argument("--prefix-cache", action="store_true",
                   help="share full prompt blocks across requests")
    p.add_argument("--shared-prompt", type=int, default=None,
                   help="tokens of a prefix every prompt shares")
    p.add_argument("--draft", choices=("none", "self", "tiny"),
                   default="none",
                   help="speculative decoding: 'self' drafts with the "
                        "model itself, 'tiny' with a seeded gpt_draft")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft proposals per speculative round")
    p.add_argument("--overlap-prefill", action="store_true",
                   help="dispatch prefill between decode steps; "
                        "admissions land at step boundaries")
    p.add_argument("--sched", choices=("monolithic", "chunked"),
                   default="monolithic",
                   help="'chunked' prefills in --chunk-budget block-wide "
                        "chunks a step boundary, with priority lanes and "
                        "per-tenant fairness")
    p.add_argument("--chunk-budget", type=int, default=2,
                   help="with --sched chunked: prefill chunks a boundary")
    p.add_argument("--priority", default="normal",
                   help="comma-separated priority cycle over the requests "
                        "(high/normal/background)")
    p.add_argument("--tenant", default=None,
                   help="comma-separated tenant cycle over the requests")
    p.add_argument("--replicas", type=int, default=1,
                   help="engines behind one ReplicaRouter queue")
    p.add_argument("--router-affinity", choices=("on", "off"),
                   default="on",
                   help="with --replicas N: route by prefix affinity "
                        "('off': load and round-robin only)")
    p.add_argument("--drain-budget", type=int, default=None,
                   help="max extra tokens a SIGTERM drain may decode")
    p.add_argument("--exit-on-preempt", action="store_true",
                   help="exit 0 after a SIGTERM drain")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--echo", action="store_true",
                   help="print every streamed token")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    p.add_argument("--tp", type=int, default=1,
                   help="not ported (ROADMAP queue 1 items 10 and 14)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="not ported (ROADMAP queue 1 item 18)")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    main()

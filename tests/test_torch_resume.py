"""The resume oracle on the port (tests/test_resilience_resume.py):
train-4, a real SIGTERM drained by `PreemptionGuard`, an atomic save,
a fresh incarnation that restores and trains 4 more steps is BITWISE
an unbroken 8-step run: parameters, every optimizer state (slots, the
step counter, the `GradSentinel`'s scalars) and the generators.

The port's GPT (vocab 64, d 32, 2 blocks, 4 heads, 8 distinct batches
of 4 x 8) trains with AdamW and a sentinel (scale 2^6, growth every 3
steps): the unrolled decoder at dropout 0.1, so each step draws masks
from the generator the checkpoint carries (a restore without the
generators' states parts from the unbroken run); the scanned stack under
each remat policy; and ZeRO-1 (`DistOpt(shard_states=True)`, no process
group) through `utils.checkpoint`, whose optimizer states are stored in
canonical form and resharded on resume.

Then the reference's second oracle, on the scanned stack: a non-finite
step injected at step 1 is skipped, the steps before it are the
fault-free run's and every step after it is the fault-free run's
shifted by one, bitwise. And the trainer: `gpt_lm --checkpoint DIR
--save-every 2` stopped after 4 steps and run again to 6 resumes at
step 4 with the losses of a run never stopped, bitwise, keeping the
newest two checkpoints.
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch import opt, resilience, storage, tensor
from singa_tpu_torch.examples import gpt_lm
from singa_tpu_torch.models.gpt import GPT
from singa_tpu_torch.resilience import GradSentinel, faults
from singa_tpu_torch.utils import checkpoint as ckpt_utils

KW = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, max_len=8)
CASES = {
    "unrolled_dropout": dict(scan_blocks=False, dropout=0.1),
    **{f"scanned_{r}": dict(scan_blocks=True, dropout=0.0, remat_policy=r)
       for r in ("none", "per_block", "dots_saveable")},
    "zero1_canonical": dict(scan_blocks=False, dropout=0.1),
}


def build(case, plan=None):
    tensor.set_seed(18)
    m = GPT(**KW, **CASES[case], device="cpu",
            generator=torch.Generator().manual_seed(18))
    base = opt.AdamW(lr=3e-3)
    o = opt.DistOpt(base, shard_states=True) if case.startswith(
        "zero1") else base
    o.set_sentinel(GradSentinel(init_scale=2.0 ** 6, growth_interval=3,
                                fault_plan=plan))
    m.set_optimizer(o)
    x, _ = batches(1)[0]
    m.compile([x], is_train=True, use_graph=True)
    return m


def batches(n, b=4, t=8, vocab=64):
    """n DISTINCT batches (a constant one would hide a lost cursor)."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        out.append((torch.from_numpy(rng.integers(0, vocab, (b, t))),
                    torch.from_numpy(rng.integers(0, vocab, (b, t)))))
    return out


def full_state(m):
    out = {f"param/{k}": v.detach().numpy().copy()
           for k, v in m.get_states().items()}
    out.update({f"opt/{k}": torch.as_tensor(v).numpy().copy()
                for k, v in m.optimizer.dump_states().items()})
    out["rng"] = tensor.get_rng_state()["cpu"]
    return out


def assert_bitwise(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{what}: {k}")


def preempted(case, directory, data):
    """train until a real SIGTERM after step 3, drained and saved."""
    m = build(case)
    with resilience.PreemptionGuard() as guard:
        for step, (x, y) in enumerate(data):
            m(x, y)
            if step == 3:
                faults.simulate_preemption()
            if guard.triggered:
                if case.startswith("zero1"):
                    ckpt_utils.save_checkpoint(m, m.optimizer, directory,
                                               step)
                else:
                    resilience.save(directory, m, m.optimizer,
                                    step=step + 1, data_cursor=step + 1)
                with pytest.raises(SystemExit) as ei:
                    guard.exit_zero()
                assert ei.value.code == 0
                break
    assert guard.triggered, "the simulated preemption must have fired"


@pytest.mark.parametrize("case", sorted(CASES))
def test_kill_restore_is_bitwise(case, tmp_path):
    data = batches(8)
    ref = build(case)
    for x, y in data:
        ref(x, y)
    want = full_state(ref)

    d = str(tmp_path / "ck")
    preempted(case, d, data)
    m = build(case)
    torch.manual_seed(12345)  # a new incarnation's own generator state
    if case.startswith("zero1"):
        start = ckpt_utils.maybe_resume(m, m.optimizer, d)
        manifest, _ = resilience.read_manifest(d)
        assert manifest["meta"] == {"opt_canonical": True}
    else:
        meta = resilience.restore(d, m, m.optimizer)
        start = meta["data_cursor"]
        assert meta["step"] == 4
    assert start == 4
    for x, y in data[start:]:
        m(x, y)
    assert_bitwise(full_state(m), want, f"resume not bitwise ({case})")


def test_the_generators_ride_the_checkpoint(tmp_path):
    """Without the generators' states the dropout run parts from the
    unbroken one: the masks are what the checkpoint's `rng` carries."""
    data = batches(8)
    ref = build("unrolled_dropout")
    for x, y in data:
        ref(x, y)
    d = str(tmp_path / "ck")
    preempted("unrolled_dropout", d, data)
    m = build("unrolled_dropout")
    torch.manual_seed(12345)
    resilience.restore(d, m, m.optimizer, set_rng=False)
    for x, y in data[4:]:
        m(x, y)
    got, want = full_state(m), full_state(ref)
    assert not np.array_equal(got["param/head.W"], want["param/head.W"])


def test_nan_skip_matches_the_fault_free_run():
    x, y = batches(1)[0]

    def run(plan):
        m = build("scanned_per_block", plan=plan)
        out = []
        for _ in range(4):
            m(x, y)
            out.append({k: v.detach().numpy().copy()
                        for k, v in m.get_params().items()})
        return m, out

    _, ref = run(None)
    m, got = run(faults.nonfinite_grad_at(1))
    for k in ref[0]:
        np.testing.assert_array_equal(ref[0][k], got[0][k], err_msg=k)
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        np.testing.assert_array_equal(got[2][k], ref[1][k], err_msg=k)
        np.testing.assert_array_equal(got[3][k], ref[2][k], err_msg=k)
    c = m.fault_counters
    assert c["nonfinite_skips"] == 1
    assert c["loss_scale"] == 2.0 ** 5  # one exact backoff from 2^6


def test_gpt_lm_resumes_bitwise(tmp_path):
    base = ["--device", "cpu", "--batch", "2", "--seq", "32", "--d-model",
            "32", "--heads", "2", "--sample-chars", "0"]
    d = str(tmp_path / "ck")

    def run(*argv):
        return gpt_lm.run(gpt_lm.parser().parse_args(base + list(argv)))

    a = run("--steps", "6")
    b = run("--steps", "4", "--checkpoint", d, "--save-every", "2")
    c = run("--steps", "6", "--checkpoint", d, "--save-every", "2")
    assert b["start"] == 0 and c["start"] == 4
    assert b["losses"] == a["losses"][:4]
    assert c["losses"] == a["losses"][4:]
    assert storage.get_driver(d).list(d) == [
        "LATEST", "step-00000004", "step-00000006"]

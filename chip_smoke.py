#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device  the card's name and power limit (nvidia-smi) and torch's name;
  2. build   both CUDA kernels from the checkout's sources, in parallel;
  3. K1      the prologue kernel against its plain version on the card,
             2,048 seeded rows at each message length 0, 33, 104, 111, 112
             and 200, exact; h also against hashlib + bigint mod L;
  4. K2      the ladder kernel against its plain version on the card, 256
             rows (the 20-row Go-edge window and seeded signatures), exact;
             verdicts against the port's own ``_verify_pure``;
  5. main    a 10,000-validator commit through ValidatorSet.verify_commit
             -> TorchBatchVerifier -> K1 -> K2: the commit passes, a flipped
             signature bit and an under-quorum commit are rejected, both
             kernels launched; wall and device times; each kernel against
             its plain version at the main path's shapes, with times and
             bounds.

The line before the last two is the ``kernels`` JSON, then the card's name
and power limit, then ``{"ok": true, "device": {...}}``. Exits 2 when no
CUDA device is present.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto.batch import TorchBatchVerifier
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import fe
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.types.validator_set import CommitError

N_VALIDATORS = 10_000  # BASELINE.json config 2
K1_ROWS = 2048
K1_LENGTHS = (0, 33, 104, 111, 112, 200)
K2_ROWS = 256
WALL_REPS = 5
TIME_ITERS = 20

# Rates for the least time the card could take: HBM bandwidth (H100 SXM
# data sheet); 32-bit integer add, logic, shift and multiply-add each retire
# at 64 per clock per SM (CUDA C++ Programming Guide throughput table,
# compute capability 9.0). A 32x32 -> 64 product (IMAD.WIDE) is counted as
# one multiply issue, the least it can cost.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLK_PER_SM = 64

# K1's integer work per SHA-512 block, in 32-bit instructions (64-bit words
# in register pairs): a round has two Sigma functions (three 64-bit rotates
# of two funnel shifts each, one LOP3 a half for the three-way xor), Ch and
# Maj (one LOP3 a half each) and five adds of up to three 64-bit inputs
# (IADD3 + IADD3.X); each of the 64 schedule words has two sigma functions
# (two rotates and a shift, one LOP3 a half) and two three-input adds; then
# eight state adds.
SHA512_BLOCK_OPS = 80 * (2 * 8 + 2 * 2 + 5 * 2) + 64 * (2 * 8 + 2 * 2) + 8 * 2
# K1's Barrett reduction mod L in radix 2^16: q1 * mu, low half of q3 * L
BARRETT_PRODUCTS = 17 * 17 + 17 * 18 // 2

REPLACES = {
    "ed25519_prologue": "tendermint_tpu/ops/ed25519_pallas.py:622",
    "ed25519_ladder": "tendermint_tpu/ops/ed25519_pallas.py:354",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


SPIN_CYCLES = 50_000_000  # ~25 ms at 1.98 GHz: longer than enqueueing 20 calls


def cuda_ms(fn, iters: int = TIME_ITERS, warmup: int = 3) -> float:
    """Mean device ms of fn() over iters back-to-back calls (CUDA events).
    A spin kernel holds the stream while the host enqueues the calls, so a
    kernel shorter than its own launch overhead is timed on the device
    alone, not at the host's enqueue rate."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_p50_ms(fn, iters: int = TIME_ITERS, warmup: int = 3) -> float:
    """Median device ms of fn(), each call timed by its own events."""
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def max_abs_diff(a_list, b_list) -> int:
    worst = 0
    for a, b in zip(a_list, b_list):
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() if a.numel() else 0
        worst = max(worst, int(d))
    return worst


def as_arrays(pubs, sigs):
    n = len(pubs)
    return (np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32),
            np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64))


def group_inputs(pubs_a, msgs, sigs_a, dev):
    """Packed kernel inputs for one uniform-length group."""
    neg_ax, ay, valid = ec._decompress_valset(pubs_a)
    valid = valid & ((sigs_a[:, 63] & 224) == 0)
    inputs, b = ec.packed_inputs(pubs_a, msgs, sigs_a, neg_ax, ay, valid,
                                 len(msgs[0]), dev)
    return inputs, valid


def phase_k1(dev, rng) -> int:
    phase(f"K1 prologue vs plain: {K1_ROWS} rows x lengths {K1_LENGTHS}")
    worst = 0
    for ln in K1_LENGTHS:
        pubs_a = rng.integers(0, 256, (K1_ROWS, 32), dtype=np.uint8)
        sigs_a = rng.integers(0, 256, (K1_ROWS, 64), dtype=np.uint8)
        if ln in (104, 112, 200):  # one template, a varying fixed64 at 17
            base = rng.integers(0, 256, ln, dtype=np.uint8)
            m = np.tile(base, (K1_ROWS, 1))
            m[:, 17:25] = rng.integers(0, 256, (K1_ROWS, 8), dtype=np.uint8)
        else:  # every byte varies
            m = rng.integers(0, 256, (K1_ROWS, ln), dtype=np.uint8)
        msgs = [m[i].tobytes() for i in range(K1_ROWS)]
        tmpl, vrows, vwords = ec.pack_variable_words(pubs_a, msgs, sigs_a, ln, K1_ROWS)
        sig_words = np.ascontiguousarray(sigs_a).view("<u4")
        pub_words = np.ascontiguousarray(pubs_a).view("<u4")
        args = [ec._put(a, dev) for a in (tmpl, vrows, vwords, pub_words, sig_words)]
        got = ec.prologue(*args)
        torch.cuda.synchronize()
        want = ec.prologue_ref(*args)
        d = max_abs_diff(got, want)
        check(d == 0, f"K1 differs from its plain version at length {ln}: {d}")
        worst = max(worst, d)
        digh = got[1].cpu().numpy()
        for i in rng.choice(K1_ROWS, 64, replace=False):
            h = int.from_bytes(hashlib.sha512(
                sigs_a[i, :32].tobytes() + pubs_a[i].tobytes() + msgs[i]).digest(),
                "little") % ed.L
            got_h = 0
            for t in range(ec.NWIN):
                got_h = (got_h << 4) | int(digh[t, i])
            check(got_h == h, f"K1 h != SHA-512 mod L at length {ln}, row {i}")
        print(f"  length {ln:3d}: rows {tmpl.shape[0]} k {vrows.shape[0]} exact", flush=True)
    return worst


def phase_k2(dev, rng) -> int:
    phase(f"K2 ladder vs plain: {K2_ROWS} rows incl. the Go-edge window")
    pubs, msgs, sigs, fixed = tc.go_edge_window(seed=1)
    n_edge = len(pubs)
    for i in range(K2_ROWS - n_edge):
        priv = ed.gen_privkey(rng.bytes(32))
        ln = tc.EDGE_LENGTHS[i % 2]
        msg = rng.bytes(ln)
        sig = bytearray(ed.sign(priv, msg))
        if i % 7 == 3:
            sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(bytes(sig))
    pubs_a, sigs_a = as_arrays(pubs, sigs)
    lens = np.array([len(m) for m in msgs])
    verdict = np.zeros(K2_ROWS, dtype=bool)
    worst = 0
    for ln in np.unique(lens):
        idx = np.nonzero(lens == ln)[0]
        inputs, valid = group_inputs(pubs_a[idx], [msgs[i] for i in idx],
                                     sigs_a[idx], dev)
        consts, negax, ay, pubw, sigw, tmpl, vidx, vwords = inputs
        digs, digh, rlimb, rsign = ec.prologue(tmpl, vidx, vwords, pubw, sigw)
        got = ec.ladder(consts, negax, ay, digs, digh, rlimb, rsign)
        torch.cuda.synchronize()
        want = ec.ladder_ref(consts, negax, ay, digs, digh, rlimb, rsign)
        d = max_abs_diff(got, want)
        check(d == 0, f"K2 differs from its plain version at length {ln}: {d}")
        worst = max(worst, d)
        verdict[idx] = (got[0][: len(idx)].cpu().numpy() != 0) & valid
        renc = got[1].cpu().numpy().astype(np.uint32)
        for j, i in enumerate(idx):
            if verdict[i]:
                enc = renc[:, j].astype("<u4").tobytes()
                check(enc == sigs[i][:32], f"K2 accepted row {i} but enc(R') != R")
    sample = list(range(n_edge)) + list(range(n_edge, K2_ROWS, 16))
    for i in sample:
        want_v = ed._verify_pure(pubs[i], msgs[i], sigs[i])
        check(bool(verdict[i]) == want_v, f"K2 row {i}: {verdict[i]} vs oracle {want_v}")
        if i in fixed and fixed[i] is not None:
            check(want_v == fixed[i], f"edge row {i} oracle {want_v} != {fixed[i]}")
    print(f"  exact on {K2_ROWS} rows; {len(sample)} verdicts match _verify_pure "
          f"({int(verdict.sum())} accepted)", flush=True)
    return worst


def expect_commit_error(fn, prefix: str) -> str:
    try:
        fn()
    except CommitError as e:
        check(str(e).startswith(prefix), f"CommitError {e!r}, want {prefix!r}")
        return str(e)
    raise SmokeFailure(f"no CommitError, want {prefix!r}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)

    phase("device")
    smi_line = smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"  nvidia-smi: {smi_line}; torch: {torch.cuda.get_device_name(0)}; "
          f"SMs {props.multi_processor_count}; max SM clock {max_sm_mhz} MHz; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    phase("build")
    secs = _build.build_all()
    for name, s in secs.items():
        print(f"  {name}: {s:.1f} s", flush=True)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print(f"    {line.strip()}")

    err = {"ed25519_prologue": phase_k1(dev, rng)}
    err["ed25519_ladder"] = phase_k2(dev, rng)

    phase(f"main path: {N_VALIDATORS}-validator commit")
    t0 = time.perf_counter()
    sc = tc.build_commit(N_VALIDATORS)
    print(f"  built and signed in {time.perf_counter() - t0:.1f} s", flush=True)
    verifier = TorchBatchVerifier()
    check(verifier.device.type == "cuda", "verifier is not on cuda")
    verify = lambda commit: sc.valset.verify_commit(
        sc.chain_id, sc.block_id, sc.height, commit, verifier=verifier)

    ec.reset_launches()
    t0 = time.perf_counter()
    verify(sc.commit)
    first_s = time.perf_counter() - t0
    walls = []
    for _ in range(WALL_REPS):
        t0 = time.perf_counter()
        verify(sc.commit)
        walls.append(time.perf_counter() - t0)
    tampered = tc.flip_signature_bit(sc.commit, N_VALIDATORS // 3, bit=300)
    expect_commit_error(lambda: verify(tampered), "invalid signature in commit")
    keep = (2 * N_VALIDATORS) // 3  # 6,666 of 10,000 equal powers: not above 2/3
    msg = expect_commit_error(lambda: verify(tc.drop_precommits(sc.commit, keep)),
                              "insufficient voting power")
    main_launches = dict(ec.launches)
    for name, count in main_launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    wall_p50 = statistics.median(walls) * 1e3
    print(f"  verify_commit: passes; first {first_s * 1e3:.1f} ms (decompress, "
          f"upload); p50 {wall_p50:.3f} ms over {WALL_REPS}; "
          f"tampered and under-quorum rejected ({msg}); launches {main_launches}",
          flush=True)

    # the main path's resident inputs, for device timings and the checks
    pubs_a, sigs_a = as_arrays(
        [v.pub_key.bytes() for v in sc.valset.validators],
        [pc.signature for pc in sc.commit.precommits])
    msgs = [pc.sign_bytes(sc.chain_id) for pc in sc.commit.precommits]
    inputs, valid = group_inputs(pubs_a, msgs, sigs_a, dev)
    consts, negax, ay, pubw, sigw, tmpl, vidx, vwords = inputs
    b = negax.shape[1]
    packed_p50 = cuda_p50_ms(lambda: ec._device_verify_packed(*inputs))
    print(f"  packed dispatch (K1 + K2, inputs resident), b = {b}: "
          f"p50 {packed_p50:.3f} ms", flush=True)

    # where verify_commit's wall time goes (host clock, p50 of WALL_REPS)
    def host_p50_ms(fn):
        samples = []
        for _ in range(WALL_REPS):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
        return statistics.median(samples) * 1e3

    raw_pubs = [v.pub_key.bytes() for v in sc.valset.validators]
    breakdown = {
        "collect_commit_sigs_ms": host_p50_ms(lambda: sc.valset.collect_commit_sigs(
            sc.chain_id, sc.block_id, sc.height, sc.commit)),
        "verify_ed25519_raw_ms": host_p50_ms(
            lambda: verifier.verify_ed25519_raw(raw_pubs, msgs, [
                pc.signature for pc in sc.commit.precommits])),
        "pack_and_upload_ms": host_p50_ms(lambda: group_inputs(pubs_a, msgs, sigs_a, dev)),
        "device_packed_p50_ms": packed_p50,
    }
    print("  breakdown: " + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()),
          flush=True)

    k1_in = (tmpl, vidx, vwords, pubw, sigw)
    k1_out = ec.prologue(*k1_in)
    k1_ref = ec.prologue_ref(*k1_in)
    err["ed25519_prologue"] = max(err["ed25519_prologue"], max_abs_diff(k1_out, k1_ref))
    k2_in = (consts, negax, ay) + tuple(k1_out)
    k2_out = ec.ladder(*k2_in)
    k2_ref = ec.ladder_ref(*k2_in)
    err["ed25519_ladder"] = max(err["ed25519_ladder"], max_abs_diff(k2_out, k2_ref))
    check(max(err.values()) == 0, f"kernel differs from its plain version: {err}")
    check(bool((k2_out[0][:N_VALIDATORS].cpu().numpy() != 0).all()),
          "main-path verdicts not all accepted")

    ms = {"ed25519_prologue": cuda_ms(lambda: ec.prologue(*k1_in)),
          "ed25519_ladder": cuda_ms(lambda: ec.ladder(*k2_in))}
    plain_ms = {"ed25519_prologue": cuda_ms(lambda: ec.prologue_ref(*k1_in), 2, 1),
                "ed25519_ladder": cuda_ms(lambda: ec.ladder_ref(*k2_in), 1, 1)}

    # least time: bytes each input read once and each output written once,
    # against 32-bit integer instructions at the card's rate. K1's SHA-512
    # runs on the integer pipe beside its Barrett products on the multiply
    # pipe, so the larger of the two counts; K2 counts the products it needs,
    # NLIMB^2 a multiplication and NLIMB(NLIMB+1)/2 a squaring.
    op_rate = props.multi_processor_count * max_sm_mhz * 1e6 * INT32_OPS_PER_CLK_PER_SM
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    nblocks = tmpl.shape[0] // 32
    k1_ops = max(nblocks * SHA512_BLOCK_OPS, BARRETT_PRODUCTS) * b
    muls, squarings = ec.ladder_fe_ops()
    k2_ops = (muls * fe.NLIMB ** 2 + squarings * fe.NLIMB * (fe.NLIMB + 1) // 2) * b
    bounds = {}
    for name, ins, outs, ops in (
            ("ed25519_prologue", k1_in, k1_out, k1_ops),
            ("ed25519_ladder", k2_in, k2_out, k2_ops)):
        t_bytes = (nbytes(ins) + nbytes(outs)) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / op_rate * 1e3
        bounds[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    for name in ms:
        print(f"  {name}: {ms[name]:.4f} ms (plain {plain_ms[name]:.1f} ms, bound "
              f"{bounds[name][0]:.4f} ms by {bounds[name][1]}) at b = {b}", flush=True)

    kernels = []
    for name in ("ed25519_prologue", "ed25519_ladder"):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"tendermint_tpu_torch/ops/csrc/{_build.SOURCES[name]}",
            "replaces": REPLACES[name],
            "launches": main_launches[name],
            "max_abs_err": err[name],
            "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": None,  # no single PyTorch call computes either function
        })
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

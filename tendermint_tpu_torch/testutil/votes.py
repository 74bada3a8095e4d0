"""Seeded vote storms and signed-transaction streams for the port's tests
and ``chip_smoke.py``, with the serial and batched vote paths they drive.

Byte for byte the workloads of the reference's benches and tests:

  * ``make_vals`` / ``make_vote``: validators of equal power whose keys come
    from fixed seeds (``KEYS_BENCH``: ``scripts/bench_votes.py``'s, two seed
    bytes repeated 16 times; ``KEYS_TEST``: ``tests/test_vote_batch.py``'s,
    one byte repeated 32 times); ``secp_every=k`` gives every k-th validator
    a secp256k1 key instead (seed ``0xA0 + i`` bytes);
  * ``build_storm``: ``scripts/bench_votes.py``'s wave-structured storm
    (2 % garbage signatures, 2 % equivocations, 10 % re-gossiped
    duplicates, 2 % mutated block ids carrying the original signature);
  * ``build_flat_storm``: ``tests/test_vote_batch.py``'s one-wave storm
    (10 % / 10 % / 10 % / 8 %);
  * ``signed_stream``: ``scripts/bench_mempool.py --signed``'s 64 senders,
    their valid txs and the mixed stream of valid, garbage-signature,
    wrong-nonce and mutant txs; ``mixed_stream``:
    ``tests/test_tx_batch.py``'s, with its secp256k1 and undecodable txs.

``run_serial`` is the reference loop (``VoteSet.add_vote`` with host
verification); ``run_batched`` the streaming path of
``scripts/bench_votes.py``: per wave, ``prevalidate``, submit to a
``VoteFeed``, ``flush_now()``, then ``add_vote(verified=True)`` in arrival
order. ``vote_set_state`` is what parity compares.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

from tendermint_tpu_torch.abci.examples.kvstore import make_signed_tx
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, PrivKeySecp256k1
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.priv_validator import MockPV
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import ErrVoteConflictingVotes, Vote, VoteError
from tendermint_tpu_torch.types.vote_set import VoteSet

BENCH_CHAIN_ID = "vote-bench-chain"  # scripts/bench_votes.py
TEST_CHAIN_ID = "vote-batch-chain"  # tests/test_vote_batch.py
TS = 1_700_000_000_000_000_000
BLOCK_A = BlockID(hash=b"a" * 32, parts_header=PartSetHeader(total=1, hash=b"p" * 32))
BLOCK_B = BlockID(hash=b"b" * 32, parts_header=PartSetHeader(total=1, hash=b"p" * 32))
ROUNDS = (0, 1)
TYPES = (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT)

# the bench's fault mix, cumulative rolls: 2 % garbage signatures, 2 %
# equivocations, 10 % re-gossiped duplicates, 2 % mutated block ids
_GARBAGE, _EQUIV, _DUP, _MUTANT = 0.02, 0.04, 0.14, 0.16

KEYS_BENCH, KEYS_TEST = "bench", "test"


def _key_seed(i: int, keys: str) -> bytes:
    if keys == KEYS_BENCH:
        return bytes([i % 255 + 1, i // 255]) * 16
    return bytes([i + 1]) * 32


def make_vals(n: int, power: int = 10, keys: str = KEYS_BENCH, secp_every: int = 0):
    """(ValidatorSet, MockPVs in the set's order)."""
    pvs = []
    for i in range(n):
        if secp_every and i % secp_every == secp_every - 1:
            priv = PrivKeySecp256k1.generate(bytes([(0xA0 + i) % 256]) * 32)
        else:
            priv = PrivKeyEd25519.generate(_key_seed(i, keys))
        pvs.append(MockPV(priv))
    vs = ValidatorSet([Validator(pv.get_pub_key(), power) for pv in pvs])
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    return vs, [by_addr[v.address] for v in vs.validators]


def make_vote(pv, vs, rnd: int, vtype, bid: BlockID, chain_id: str = BENCH_CHAIN_ID,
              height: int = 1) -> Vote:
    addr = pv.get_pub_key().address()
    idx, _ = vs.get_by_address(addr)
    vote = Vote(vote_type=vtype, height=height, round=rnd, timestamp_ns=TS,
                block_id=bid, validator_address=addr, validator_index=idx)
    return pv.sign_vote(chain_id, vote)


def build_storm(vs, pvs, seed: int = 7, waves: int = 6,
                chain_id: str = BENCH_CHAIN_ID) -> List[List[tuple]]:
    """Waves of shuffled (group_key, vote), group_key = (round, type).
    Every honest vote lands in a random wave; its duplicates and mutants
    trail it by a wave or more, equivocations arrive any time after,
    garbage alongside (``scripts/bench_votes.py:build_storm``)."""
    rng = random.Random(seed)
    out: List[List[tuple]] = [[] for _ in range(waves)]
    for rnd in ROUNDS:
        for vtype in TYPES:
            gk = (rnd, vtype)
            for pv in pvs:
                vote = make_vote(pv, vs, rnd, vtype, BLOCK_A, chain_id)
                w = rng.randrange(waves)
                out[w].append((gk, vote))
                roll = rng.random()
                if roll < _GARBAGE:
                    bad = vote.with_signature(bytes(rng.randrange(256) for _ in range(64)))
                    out[w].append((gk, bad))
                elif roll < _EQUIV:
                    ev = make_vote(pv, vs, rnd, vtype, BLOCK_B, chain_id)
                    out[rng.randrange(w, waves)].append((gk, ev))
                elif roll < _DUP:
                    out[min(w + 1 + rng.randrange(2), waves - 1)].append((gk, vote))
                elif roll < _MUTANT:
                    mut = make_vote(pv, vs, rnd, vtype, BLOCK_B, chain_id).with_signature(
                        vote.signature)
                    out[min(w + 1, waves - 1)].append((gk, mut))
    for wave in out:
        rng.shuffle(wave)
    return out


def build_flat_storm(vs, pvs, seed: int = 7, rounds=ROUNDS,
                     chain_id: str = TEST_CHAIN_ID) -> List[tuple]:
    """One shuffled [(group_key, vote)] (``tests/test_vote_batch.py:
    build_storm``): 10 % garbage, 10 % equivocations, 10 % duplicates, 8 %
    mutated block ids."""
    rng = random.Random(seed)
    storm = []
    for rnd in rounds:
        for vtype in TYPES:
            gk = (rnd, vtype)
            group = []
            for pv in pvs:
                vote = make_vote(pv, vs, rnd, vtype, BLOCK_A, chain_id)
                group.append(vote)
                roll = rng.random()
                if roll < 0.10:
                    group.append(vote.with_signature(
                        bytes(rng.randrange(256) for _ in range(64))))
                elif roll < 0.20:
                    group.append(make_vote(pv, vs, rnd, vtype, BLOCK_B, chain_id))
                elif roll < 0.30:
                    group.append(vote)
                elif roll < 0.38:
                    group.append(make_vote(pv, vs, rnd, vtype, BLOCK_B, chain_id)
                                 .with_signature(vote.signature))
            rng.shuffle(group)
            storm.extend((gk, v) for v in group)
    rng.shuffle(storm)
    return storm


def fresh_sets(vs, chain_id: str = BENCH_CHAIN_ID, rounds=ROUNDS) -> Dict[tuple, VoteSet]:
    return {(rnd, vtype): VoteSet(chain_id, 1, rnd, vtype, vs)
            for rnd in rounds for vtype in TYPES}


def _apply(vset, vote, verified: bool, outcomes, evidence, gk) -> None:
    try:
        outcomes.append(("added", vset.add_vote(vote, verified=verified)))
    except ErrVoteConflictingVotes as e:
        outcomes.append(("conflict", e.added))
        evidence.append((gk, e.vote_a, e.vote_b))
    except VoteError as e:
        outcomes.append((type(e).__name__, None))


def run_serial(sets, waves) -> Tuple[list, list]:
    """The reference path: one ``add_vote`` a vote, host verification.
    ``waves`` is a list of waves (a flat storm is one wave)."""
    outcomes, evidence = [], []
    for wave in waves:
        for gk, vote in wave:
            _apply(sets[gk], vote, False, outcomes, evidence, gk)
    return outcomes, evidence


def run_batched(sets, waves, feed, timeout: float = 600.0) -> Tuple[list, list]:
    """The streaming path: per wave, prevalidate and park every signature
    in the feed, flush, then apply the wave's verdicts in arrival order
    before the next wave (``scripts/bench_votes.py:run_batched``). A failed
    verdict is re-prevalidated, as the consensus state does, so that a
    structural rejection that arose in flight keeps the serial path's
    error class."""
    outcomes, evidence = [], []
    pos = 0
    for wave in waves:
        pending = []
        for gk, vote in wave:
            p = pos
            pos += 1
            vset = sets[gk]
            try:
                pv = vset.prevalidate(vote)
            except VoteError as e:
                outcomes.append((p, (type(e).__name__, None)))
                continue
            if pv is None:
                outcomes.append((p, ("added", False)))
                continue
            ticket = feed.submit(
                gk, pv.pub_key, vote.sign_bytes(vset.chain_id), vote.signature,
                power=pv.voting_power, total=vset.val_set.total_voting_power(),
            )
            pending.append((p, gk, vote, ticket))
        if pending:
            feed.flush_now()
        for p, gk, vote, ticket in pending:
            vset = sets[gk]
            if not ticket.result(timeout=timeout).ok:
                try:
                    if vset.prevalidate(vote) is None:
                        outcomes.append((p, ("added", False)))
                    else:
                        outcomes.append((p, ("ErrVoteInvalidSignature", None)))
                except VoteError as e:
                    outcomes.append((p, (type(e).__name__, None)))
                continue
            got: list = []
            _apply(vset, vote, True, got, evidence, gk)
            outcomes.append((p, got[0]))
    outcomes.sort(key=lambda o: o[0])
    return [o for _, o in outcomes], evidence


def evidence_key(evidence) -> list:
    """Evidence pairs as comparable (group key, signature, signature)."""
    return sorted((tuple(int(x) for x in gk), a.signature, b.signature)
                  for gk, a, b in evidence)


def vote_set_state(sets, blocks=(BLOCK_A, BLOCK_B)) -> dict:
    """Per set: the bit array's bytes, the sum, the maj23 block's key and
    each block's bit array: what storm parity compares."""
    out = {}
    for gk, s in sets.items():
        maj = s.two_thirds_majority()
        per_block = []
        for bid in blocks:
            ba = s.bit_array_by_block_id(bid)
            per_block.append(None if ba is None else ba.marshal())
        out[tuple(int(x) for x in gk)] = (
            s.bit_array().marshal(), s.sum, None if maj is None else maj.key(),
            tuple(per_block))
    return out


def signed_stream(n: int = 512, n_keys: int = 64):
    """``scripts/bench_mempool.py``'s signed workload: (privs, n valid txs
    from ``n_keys`` senders with sequential nonces, the mixed stream of a
    valid, a garbage-signature, a wrong-nonce and a mutant tx a sender)."""
    n_keys = min(n_keys, n)
    privs = [PrivKeyEd25519.generate(b"bench-signed-%03d" % i + b"\x00" * 16)
             for i in range(n_keys)]
    txs = [make_signed_tx(privs[i % n_keys], i // n_keys + 1, b"sb%07d=v" % i)
           for i in range(n)]
    mixed = []
    for i in range(n_keys):
        nonce = n // n_keys + 1
        mixed.append(make_signed_tx(privs[i], nonce, b"mx%04d=v" % i))
        garbage = bytearray(make_signed_tx(privs[i], nonce + 1, b"mg%04d=v" % i))
        garbage[-8] ^= 0x55
        mixed.append(bytes(garbage))
        mixed.append(make_signed_tx(privs[i], nonce + 77, b"mw%04d=v" % i))
        mutant = bytearray(make_signed_tx(privs[i], nonce + 1, b"mm%04d=v" % i))
        mutant[-1] ^= 0x01
        mixed.append(bytes(mutant))
    return privs, txs, mixed


def mixed_stream() -> List[bytes]:
    """``tests/test_tx_batch.py:mixed_stream``: six ed25519 senders' valid,
    garbage-signature, wrong-nonce and mutant txs, a secp256k1 tx and an
    undecodable one."""
    privs = [PrivKeyEd25519.generate(bytes([i + 1]) * 32) for i in range(6)]
    secp = PrivKeySecp256k1.generate(b"\x77" * 32)
    txs = []
    for i, p in enumerate(privs):
        txs.append(make_signed_tx(p, 1, b"v%02d=a" % i))
        garbage = bytearray(make_signed_tx(p, 2, b"g%02d=b" % i))
        garbage[-6] ^= 0x55
        txs.append(bytes(garbage))
        txs.append(make_signed_tx(p, 9, b"w%02d=c" % i))
        mutant = bytearray(make_signed_tx(p, 2, b"m%02d=d" % i))
        mutant[-1] ^= 0x01
        txs.append(bytes(mutant))
    txs.append(make_signed_tx(secp, 1, b"secp=e"))
    txs.append(b"\x00not-a-signed-tx")
    return txs

"""Deterministic synthetic token stream, on a torch RNG.

Counterpart of ``src/repro/data/synthetic.py`` (:25-98): Zipf unigrams
over the vocabulary, replaced with probability 0.65 by an order-1 Markov
chain ``t -> (31·t + 7) mod max(vocab // 4, 2)`` from a random start, so a
model trained on it has structure to learn and compression quality is
measurable.  The bits differ from ``jax.random``'s; the distribution is the
same.

Every draw comes from a CPU ``torch.Generator`` seeded from (seed, step,
process_index) alone, and the result is then moved to the requested
device, so a batch's bits depend on nothing else: a restarted run
regenerates exactly the batch it stopped at, and the card and the CPU see
the same tokens.  Unigrams are sampled by inverse CDF (``searchsorted`` on
the fp64 Zipf CDF), exact and cheap at vocab 151936.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device

CHAIN_A, CHAIN_B, CHAIN_P = 31, 7, 0.65


def _generator(*entropy: int) -> torch.Generator:
    """A CPU generator seeded from ``entropy`` (non-negative ints) through
    numpy's ``SeedSequence``, so nearby (seed, step) pairs get unrelated
    streams."""
    state = np.random.SeedSequence(list(entropy)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


@functools.lru_cache(maxsize=8)
def _zipf_cdf(vocab: int) -> torch.Tensor:
    p = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64)
    return torch.cumsum(p / p.sum(), 0)


def _chain(start: torch.Tensor, length: int, alphabet: int) -> torch.Tensor:
    """(n, length): step t holds the chain's (t + 1)-th successor of
    ``start``, f^(t+1)(s) = A_t·s + B_t mod alphabet, with (A_t, B_t) the
    composed affine maps (plain ints, so nothing overflows)."""
    coef, off, pairs = 1, 0, []
    for _ in range(length):
        coef, off = (CHAIN_A * coef) % alphabet, (CHAIN_A * off + CHAIN_B) \
            % alphabet
        pairs.append((coef, off))
    a, b = torch.tensor(pairs, dtype=torch.int64).T
    return (a[None] * start[:, None] + b[None]) % alphabet


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Move a host tensor to ``dev``; to the card through pinned memory,
    without waiting for the card's queued work."""
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def synthetic_tokens(gen: torch.Generator, n: int, length: int, vocab: int
                     ) -> torch.Tensor:
    """(n, length) int32 tokens on the CPU: Zipf unigrams + order-1 Markov
    structure, drawn from ``gen`` (a CPU generator)."""
    u = torch.rand(n, length, generator=gen, dtype=torch.float64)
    uni = torch.searchsorted(_zipf_cdf(vocab), u, right=True).clamp_(
        max=vocab - 1)
    alphabet = max(vocab // 4, 2)
    start = torch.randint(0, alphabet, (n,), generator=gen)
    chain = _chain(start, length, alphabet)
    gate = torch.rand(n, length, generator=gen) < CHAIN_P
    return torch.where(gate, chain, uni).to(torch.int32)


def lm_batch(gen: torch.Generator, batch: int, seq_len: int, vocab: int
             ) -> Dict[str, torch.Tensor]:
    """Next-token LM batch on the CPU: tokens and the labels one ahead."""
    toks = synthetic_tokens(gen, batch, seq_len + 1, vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_iterator(cfg, batch: int, seq_len: int, *, seed: int = 0,
                        start_step: int = 0, process_index: int = 0,
                        process_count: int = 1, device=None
                        ) -> Iterator[Dict[str, torch.Tensor]]:
    """Deterministic per-step batches of ``batch // process_count`` rows
    (this process's shard), step ``start_step`` first, on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    step = start_step
    local = batch // process_count
    while True:
        gen = _generator(seed, step, process_index)
        b = lm_batch(gen, local, seq_len, cfg.vocab_size)
        b = _add_frontend_inputs(cfg, gen, b, local, seq_len)
        yield {k: _to(v, dev) for k, v in b.items()}
        step += 1


def _add_frontend_inputs(cfg, gen, batch, n, seq_len):
    """Vision: 0.02·N(0, 1) patches before the tokens, the tokens cut so
    patches + tokens fill ``seq_len``, and labels over patches + tokens
    with zeros under the patches (ROADMAP hazard 3l).  Audio: 0.02·N(0, 1)
    frames for the encoder."""
    if cfg.frontend == "vision":
        batch["patches"] = 0.02 * torch.randn(n, cfg.num_patches,
                                              cfg.d_model, generator=gen)
        pad = torch.zeros((n, cfg.num_patches), dtype=torch.int32)
        batch["labels"] = torch.cat([pad, batch["labels"]], 1)[:, :seq_len]
        batch["tokens"] = batch["tokens"][:, : seq_len - cfg.num_patches]
    if cfg.frontend == "audio":
        batch["frames"] = 0.02 * torch.randn(n, cfg.encoder_seq_len,
                                             cfg.d_model, generator=gen)
    return batch


def calibration_set(cfg, n: int, seq_len: int, *, seed: int = 1234,
                    device=None) -> Dict[str, torch.Tensor]:
    """The paper's calibration set (256 × 2048 at full scale): ``n``
    sequences of ``seq_len`` tokens, with patches / frames for the
    multimodal archs, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    gen = _generator(seed)
    calib = {"tokens": synthetic_tokens(gen, n, seq_len, cfg.vocab_size)}
    if cfg.frontend == "vision":
        calib["patches"] = 0.02 * torch.randn(n, cfg.num_patches,
                                              cfg.d_model, generator=gen)
    if cfg.frontend == "audio":
        calib["frames"] = 0.02 * torch.randn(n, cfg.encoder_seq_len,
                                             cfg.d_model, generator=gen)
    return {k: _to(v, dev) for k, v in calib.items()}

"""The port's synthetic data pipeline against ``repro.data``.

The bits of ``jax.random`` and ``torch.Generator`` differ, so the two
streams are held to the same structure, not the same tokens: on 1024 × 64
tokens of each (vocab 256), the share of chain-consistent transitions (t+1
= (31·t + 7) mod vocab // 4; ~0.43) within 0.02 and the Zipf head's
frequencies (ranks 1-8; token 0 ~0.068) within 0.008 of each other.  The
chain's short cycles make a sequence's tokens correlated, so the spread is
wider than independent draws would give: over seeds 0-5 the two packages'
gaps reached 0.0101 and 0.0046.  Everything else (determinism,
resumption, shards, shapes, frontend inputs) is exact.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.core import zoo
from repro.data import synthetic as JD
from repro_torch import configs as TC
from repro_torch.data import synthetic as TD


def _cfg(arch="qwen3-0.6b"):
    return TC.get_smoke_config(arch).replace(dtype="float32")


def _take(it, n):
    return list(itertools.islice(it, n))


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_batches_are_a_function_of_seed_and_step():
    cfg = _cfg()
    a = _take(TD.make_batch_iterator(cfg, 4, 32, seed=3, device="cpu"), 3)
    b = _take(TD.make_batch_iterator(cfg, 4, 32, seed=3, device="cpu"), 3)
    c = _take(TD.make_batch_iterator(cfg, 4, 32, seed=4, device="cpu"), 1)
    assert all(_equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])
    assert not torch.equal(a[0]["tokens"], c[0]["tokens"])


def test_start_step_resumes_the_stream():
    cfg = _cfg()
    whole = _take(TD.make_batch_iterator(cfg, 4, 32, seed=0, device="cpu"),
                  5)
    resumed = _take(TD.make_batch_iterator(cfg, 4, 32, seed=0, start_step=3,
                                           device="cpu"), 2)
    assert _equal(resumed[0], whole[3]) and _equal(resumed[1], whole[4])


def test_labels_are_the_next_tokens():
    b = next(TD.make_batch_iterator(_cfg(), 4, 32, device="cpu"))
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert b["tokens"].shape == b["labels"].shape == (4, 32)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_shards_are_disjoint():
    cfg = _cfg()
    shards = [next(TD.make_batch_iterator(cfg, 8, 32, seed=0,
                                          process_index=i, process_count=2,
                                          device="cpu")) for i in (0, 1)]
    whole = next(TD.make_batch_iterator(cfg, 8, 32, seed=0, device="cpu"))
    assert all(s["tokens"].shape == (4, 32) for s in shards)
    rows = [tuple(r.tolist()) for s in shards for r in s["tokens"]]
    assert len(set(rows)) == len(rows)
    assert not torch.equal(shards[0]["tokens"], whole["tokens"][:4])


@pytest.mark.parametrize("vocab", (2, 7, 256, 151936))
def test_tokens_lie_in_the_vocab(vocab):
    gen = torch.Generator().manual_seed(vocab)
    t = TD.synthetic_tokens(gen, 16, 257, vocab)
    assert t.dtype == torch.int32 and t.shape == (16, 257)
    assert int(t.min()) >= 0 and int(t.max()) < vocab


def _stats(tokens, vocab, head=8):
    t = np.asarray(tokens, np.int64)
    alphabet = max(vocab // 4, 2)
    chain = float(np.mean(t[:, 1:] == (31 * t[:, :-1] + 7) % alphabet))
    freq = np.bincount(t.ravel(), minlength=vocab)[:head] / t.size
    return chain, freq


def test_structure_matches_reference():
    vocab = 256
    want = _stats(JD.synthetic_tokens(jax.random.PRNGKey(0), 1024, 64,
                                      vocab), vocab)
    got = _stats(TD.synthetic_tokens(TD._generator(0), 1024, 64, vocab),
                 vocab)
    assert 0.35 < got[0] < 0.55, got[0]
    assert abs(got[0] - want[0]) < 0.02, (got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=0.008)
    assert got[1][0] > got[1][1] > got[1][3]   # the Zipf head decays


@pytest.mark.parametrize("arch", ("phi-3-vision-4.2b", "whisper-base"))
def test_frontend_batches_match_reference(arch):
    # the reference's keys, shapes and dtypes; a vision batch's labels are
    # zeros under the patches then the text labels (hazard 3l)
    cfg, tcfg = zoo.smoke_cfg(arch), _cfg(arch)
    want = next(JD.make_batch_iterator(cfg, 4, 40, seed=0))
    got = next(TD.make_batch_iterator(tcfg, 4, 40, seed=0, device="cpu"))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
    if cfg.frontend == "vision":
        p = cfg.num_patches
        assert not bool(got["labels"][:, :p].any())
        assert torch.equal(got["labels"][:, p:-1], got["tokens"][:, 1:])
    x = got.get("patches", got.get("frames"))
    assert 0.015 < float(x.std()) < 0.025


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "phi-3-vision-4.2b",
                                  "whisper-base"))
def test_calibration_set_matches_reference(arch):
    cfg, tcfg = zoo.smoke_cfg(arch), _cfg(arch)
    want = JD.calibration_set(cfg, 3, 40)
    got = TD.calibration_set(tcfg, 3, 40, device="cpu")
    again = TD.calibration_set(tcfg, 3, 40, device="cpu")
    assert set(got) == set(want) and _equal(got, again)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
    other = TD.calibration_set(tcfg, 3, 40, seed=5, device="cpu")
    assert not torch.equal(other["tokens"], got["tokens"])


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(TD.make_batch_iterator(_cfg(), 2, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.calibration_set(_cfg(), 2, 8)

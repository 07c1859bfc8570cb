"""Serving engine for (optionally AA-SVD-compressed) models.

Counterpart of ``src/repro/launch/serve.py``: ``_pad_batch``,
``_prefill_extra_len``, ``Server`` (``generate``), ``Request``, ``_bucket``,
``ContinuousBatchingServer`` and ``main``, with no mesh.  Both engines run
on the card unless the caller passes ``device="cpu"``; the params are moved
there (no copy when they already live there).

``Server`` — fixed batch: one prefill of every prompt, then lock-step
decode.  Its cache is built WITHOUT params.  For the dense archs' ``"attn"``
blocks (llama, qwen3, granite, phi3-medium), gemma3's ``"attn_global"``
ones and kimi-k2's ``"attn_dense_first"`` / ``"attn_moe"`` ones it is
dense: prefill through ``gqa_prefill`` and decode through ``gqa_decode``,
both on the ``flash_attention`` kernel (decode with Lq = 1 at one
position).  gemma3's ``"attn_local"`` blocks keep a ring of
``sliding_window`` slots: windowed prefill on ``flash_attention``, then
``ring_decode`` (fp32 einsums).  For deepseek's MLA blocks it is the compressed {"c",
"kr"} cache: whole prefill through ``mla_prefill`` (``flash_attention`` at
head dim 192) and decode through ``mla_decode`` (absorbed fp32 einsums).

``ContinuousBatchingServer`` — the engine.  The cache is allocated once for
``slots`` sequences of ``max_len`` positions with the params, so a
compressed llama (granite, phi3-medium, kimi-k2: every GQA arch without
qk_norm) gets the latent {"lk", "lv"} layout: prefill through
``gqa_prefill_latent`` (``flash_attention`` over the up-projected cache) and
decode through ``gqa_decode_latent`` (the ``flash_decode`` kernel);
``cache_layout="dense"`` forces dense k/v everywhere.  gemma3 keeps its
rings and dense global caches (qk_norm), and every request takes
exact-length whole prefill (``"whole_exact"``): a ring can neither resume
mid-sequence nor take right-padding.  kimi-k2's head dim 112 reaches
``flash_decode`` and ``flash_attention`` as it is (both have bodies at D
112 and 96).  falcon-mamba's Mamba1 and zamba2's Mamba2 layers keep
their recurrent {"h", "conv"} state a slot, so every request of those
archs takes ``"whole_exact"`` prefill too; zamba2's shared attention sites
(head dim 112, 32 heads on 32 KV heads) each keep their own latent or
dense cache.  The multimodal archs take their modality inputs as
``extras``: phi-3-vision's ``patches`` (P, d) a request are spliced before
its tokens, so its prefill writes P + the prompt's positions and decode
starts past them (head dim 96: ``flash_decode``'s D-96 bodies over the
latent cache); whisper's ``frames`` (1500, d) a request run through the
encoder once at prefill and fill only the cross-attention cache {"xk",
"xv"} (dense, carried by ``cache_slot_take`` / ``cache_slot_put`` with the
rest of a slot's cache), its decoder's self-attention cache holding the
prompt alone.  A request with extras is prefilled whole at its bucketed
width (``"whole_extras"``), as in the JAX package.  MLA blocks keep
{"c", "kr"} under either layout: chunked prefill through
``mla_prefill_cached`` and decode through ``mla_decode`` (absorbed), whole
prefill through ``mla_prefill``.  Under deepseek's capacity MoE dispatch
the outputs depend on the batch, as in the JAX package: the zero rows
``Server`` pads to its batch, the zero tokens of a padded prefill bucket
and the parked slots of a decode step all take capacity slots.  ``run(requests)``
admits requests into free slots once their ``arrival`` offset has passed,
prefills each alone (``cache_slot_take`` -> prefill -> ``cache_slot_put``,
whole or in ``prefill_chunk``-wide chunks), then decodes ALL slots as one
batched step with a per-slot position vector.  Parked slots ride along at
position 0; what they write is overwritten by the next admission's prefill
or masked by the per-slot length.  ``prefill_routes`` records which prefill
path served each request and ``decode_step_times`` the wall time of every
decode step of the last run (each ends in a host read of the tokens, which
waits for the card).

    python -m repro_torch.launch.serve --arch llama-7b --smoke --ratio 0.6 \\
        [--engine] [--device cpu]
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --smoke \\
        [--engine] [--device cpu]
    python -m repro_torch.launch.serve --arch gemma3-1b --smoke --ratio 0.6 \\
        [--engine] [--device cpu]     # also qwen3-0.6b, granite-3-8b,
                                      # phi3-medium-14b, kimi-k2-1t-a32b,
                                      # falcon-mamba-7b, zamba2-7b
    python -m repro_torch.launch.serve --arch whisper-base --smoke \\
        --ratio 0.6 [--engine] [--device cpu]   # also phi-3-vision-4.2b
    python -m repro_torch.launch.serve --arch llama-7b --smoke --ratio 0.6 \\
        --calib-mode hybrid --rank-mode adaptive --replay-taps auto \\
        --checkpoint /tmp/ckpt [--engine] [--device cpu]

``Server.from_checkpoint`` and ``ContinuousBatchingServer.from_checkpoint``
serve a format-3 checkpoint (``repro_torch.checkpoint``, or the JAX
package's) from the arch config and the directory alone: the param tree is
rebuilt from the manifest on the server's device.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pipeline as P
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.tree import tree_map


def _pad_batch(x, n: int):
    """Pad axis 0 of ``x`` with zeros up to ``n`` rows."""
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _prefill_extra_len(cfg) -> int:
    """Cache positions prefill writes BEYOND the text tokens (vision
    patches precede them)."""
    return cfg.num_patches if cfg.frontend == "vision" else 0


def _to_device(params, dev):
    return tree_map(lambda t: t.to(dev), params)


def _restore(directory: str, step, device):
    mgr = CheckpointManager(directory, async_save=False)
    return mgr.restore_tree(step, device=device)


class Server:
    """Fixed-batch serving frontend (one prefill + lock-step decode)."""

    def __init__(self, cfg, params, *, max_len: int = 256, batch: int = 4,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.max_len = max_len
        self.batch = batch
        self._serve = S.make_serve_step(cfg)
        self._prefill = S.make_prefill_step(cfg)

    @classmethod
    def from_checkpoint(cls, cfg, directory: str, *, step: int = None,
                        max_len: int = 256, batch: int = 4, device=None):
        """Serve the params of a checkpoint directory (the latest step
        unless ``step``), rebuilt from its manifest alone
        (``restore_tree``) on ``device`` (None: the card).  The manifest's
        ``meta`` lands on ``server.checkpoint_meta``."""
        _, params, meta = _restore(directory, step, device)
        server = cls(cfg, params, max_len=max_len, batch=batch,
                     device=device)
        server.checkpoint_meta = meta
        return server

    def generate(self, prompts, *, steps: int = 32,
                 extras: Optional[dict] = None) -> torch.Tensor:
        """prompts: (b, prompt_len) integers, b <= batch -> (b, steps)
        int32 on the server's device.  ``extras``: modality inputs with a
        leading b axis (``patches`` (b, P, d) or ``frames`` (b, Le, d)),
        zero-padded to the batch as the prompts are."""
        prompts = torch.as_tensor(prompts)
        b, plen = prompts.shape
        if b > self.batch:
            raise ValueError(
                f"got {b} prompts but the server advertises batch="
                f"{self.batch} decode slots; split the request or raise "
                "Server(batch=...)")
        prefill_len = plen + _prefill_extra_len(self.cfg)
        if prefill_len + steps > self.max_len:
            raise ValueError(
                f"prefill length ({prefill_len}) + steps ({steps}) = "
                f"{prefill_len + steps} exceeds the cache capacity max_len "
                f"({self.max_len}); raise Server(max_len=...) or generate "
                "fewer steps")
        prompts = _pad_batch(prompts.to(self.device, torch.int32),
                             self.batch)
        extras = {k: _pad_batch(torch.as_tensor(v).to(self.device),
                                self.batch)
                  for k, v in (extras or {}).items()}
        cache = M.init_cache(self.cfg, self.batch, self.max_len,
                             device=self.device)
        next_tok, cache = self._prefill(self.params,
                                        {"tokens": prompts, **extras}, cache)
        tok = next_tok[:, None]
        out = [tok]
        pos = prefill_len
        for _ in range(steps - 1):
            tok, cache = self._serve(self.params, cache, tok, pos)
            out.append(tok)
            pos += 1
        return torch.cat(out, dim=1)[:b]


@dataclasses.dataclass
class Request:
    """One serving request for :class:`ContinuousBatchingServer`;
    ``extras`` its modality inputs with a leading axis of 1 (``patches`` or
    ``frames``); ``arrival`` is the offset (seconds from ``run`` start) at
    which the scheduler sees it."""

    rid: int
    prompt: np.ndarray               # (prompt_len,) integers
    steps: int
    extras: Optional[dict] = None    # modality inputs, leading axis 1
    arrival: float = 0.0


def _bucket(n: int, lo: int = 16) -> int:
    """Next power-of-two width >= n (floor ``lo``)."""
    w = lo
    while w < n:
        w *= 2
    return w


class ContinuousBatchingServer:
    """Slot-level continuous batching over one shared decode cache."""

    def __init__(self, cfg, params, *, max_len: int = 256, slots: int = 4,
                 prefill_chunk: int = 0, cache_layout: str = "auto",
                 device=None):
        if cache_layout not in ("auto", "dense"):
            raise ValueError(f"cache_layout {cache_layout!r}: 'auto' or "
                             "'dense'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.max_len = max_len
        self.slots = slots
        self.prefill_chunk = prefill_chunk
        # SSM state and ring caches can neither resume mid-sequence nor
        # take right-padded prompts -> exact-length whole prefill
        self._exact = (cfg.family in ("ssm", "hybrid")
                       or cfg.attention == "sliding_mix")
        self._decode = S.make_serve_step(cfg)
        self._pre_whole = S.make_slot_prefill_step(cfg, chunked=False)
        self._pre_chunk = S.make_slot_prefill_step(cfg, chunked=True)
        self._cache_params = None if cache_layout == "dense" else self.params
        self.decode_step_times: List[float] = []
        # rid -> the prefill path that served it ("whole_exact" |
        # "whole_extras" | "whole_padded" | "chunked"); reset per run()
        self.prefill_routes: Dict[int, str] = {}

    @classmethod
    def from_checkpoint(cls, cfg, directory: str, *, step: int = None,
                        max_len: int = 256, slots: int = 4,
                        prefill_chunk: int = 0, cache_layout: str = "auto",
                        device=None):
        """Engine twin of :meth:`Server.from_checkpoint`."""
        _, params, meta = _restore(directory, step, device)
        server = cls(cfg, params, max_len=max_len, slots=slots,
                     prefill_chunk=prefill_chunk, cache_layout=cache_layout,
                     device=device)
        server.checkpoint_meta = meta
        return server

    def _tokens(self, host: np.ndarray) -> torch.Tensor:
        return torch.tensor(host, device=self.device)

    # ------------------------------------------------------------------
    def _admit(self, req: Request, cache, slot: int):
        """Prefill ``req`` into ``slot``.  Returns (first token, cache,
        prefill length)."""
        cfg = self.cfg
        prompt = np.asarray(req.prompt, np.int32)
        plen = int(prompt.shape[0])
        extra = _prefill_extra_len(cfg)
        total = plen + extra
        if total + req.steps > self.max_len:
            raise ValueError(
                f"request {req.rid}: prefill length ({total}) + steps "
                f"({req.steps}) exceeds max_len ({self.max_len})")
        slot_cache = M.cache_slot_take(cfg, cache, slot)
        extras = {k: torch.as_tensor(v).to(self.device)
                  for k, v in (req.extras or {}).items()}
        chunk = self.prefill_chunk
        self.prefill_routes[req.rid] = (
            "whole_exact" if self._exact
            else "whole_extras" if extras
            else "whole_padded" if chunk <= 0
            else "chunked")
        if self._exact or extras or chunk <= 0:
            if self._exact:
                toks = prompt[None]              # exact length, no padding
                last_idx = total - 1
            else:
                w = min(_bucket(plen), self.max_len - extra)
                toks = np.zeros((1, w), np.int32)
                toks[0, :plen] = prompt
                last_idx = extra + plen - 1
            tok, slot_cache = self._pre_whole(
                self.params, {"tokens": self._tokens(toks), **extras},
                slot_cache, 0, last_idx)
        else:
            padded = -(-plen // chunk) * chunk
            buf = np.zeros((padded,), np.int32)
            buf[:plen] = prompt
            tok = None
            for c0 in range(0, padded, chunk):
                last = c0 + chunk >= padded
                last_idx = (plen - 1 - c0) if last else (chunk - 1)
                tok, slot_cache = self._pre_chunk(
                    self.params, {"tokens": self._tokens(
                        buf[None, c0:c0 + chunk])},
                    slot_cache, c0, last_idx)
        cache = M.cache_slot_put(cfg, cache, slot_cache, slot)
        return int(tok[0]), cache, total

    # ------------------------------------------------------------------
    def run(self, requests: List[Request]) -> Dict[int, Dict[str, Any]]:
        """Serve every request; returns {rid: {tokens, arrival, admitted,
        first_token, done}} with times in seconds from run start."""
        cfg = self.cfg
        queue = sorted(requests, key=lambda r: (r.arrival, r.rid))
        cache = M.init_cache(cfg, self.slots, self.max_len,
                             params=self._cache_params, device=self.device)
        tokens_np = np.zeros((self.slots, 1), np.int32)
        pos_np = np.zeros((self.slots,), np.int32)
        active: List[Optional[dict]] = [None] * self.slots
        results: Dict[int, Dict[str, Any]] = {}
        self.decode_step_times = []
        self.prefill_routes = {}
        start = time.monotonic()
        now = lambda: time.monotonic() - start  # noqa: E731
        qi = 0

        def finish(slot):
            st = active[slot]
            results[st["req"].rid] = {
                "tokens": np.asarray(st["out"], np.int32),
                "arrival": st["req"].arrival, "admitted": st["admitted"],
                "first_token": st["first_token"], "done": now()}
            active[slot] = None
            pos_np[slot] = 0
            tokens_np[slot, 0] = 0

        while qi < len(queue) or any(s is not None for s in active):
            # admission: refill every free slot whose request has arrived
            for slot in range(self.slots):
                if active[slot] is not None or qi >= len(queue):
                    continue
                if queue[qi].arrival > now():
                    continue
                req = queue[qi]
                qi += 1
                t_admit = now()
                tok0, cache, total = self._admit(req, cache, slot)
                active[slot] = {"req": req, "out": [tok0],
                                "remaining": req.steps - 1,
                                "admitted": t_admit, "first_token": now()}
                tokens_np[slot, 0] = tok0
                pos_np[slot] = total
                if active[slot]["remaining"] <= 0:
                    finish(slot)
            if not any(s is not None for s in active):
                if qi < len(queue):      # idle until the next arrival
                    time.sleep(max(0.0, queue[qi].arrival - now()))
                continue
            # one batched decode step over ALL slots (parked slots sit at
            # position 0; their writes are overwritten or masked)
            t_step = time.monotonic()
            tok_dev, cache = self._decode(self.params, cache,
                                          self._tokens(tokens_np),
                                          self._tokens(pos_np))
            # repro-check: allow[host-sync-loop] — the engine schedules on the step's tokens (finish, admit): its one read a decode step
            tok_host = tok_dev.cpu().numpy()
            self.decode_step_times.append(time.monotonic() - t_step)
            for slot in range(self.slots):
                st = active[slot]
                if st is None:
                    continue
                st["out"].append(int(tok_host[slot, 0]))
                tokens_np[slot, 0] = tok_host[slot, 0]
                pos_np[slot] += 1
                st["remaining"] -= 1
                if st["remaining"] <= 0:
                    finish(slot)
        return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a (compressed) model from repro_torch")
    ap.add_argument("--arch", default="llama-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ratio", type=float, default=1.0,
                    help="<1: AA-SVD-compress before serving")
    ap.add_argument("--calib-mode", default="sequential",
                    choices=["sequential", "fused", "hybrid", "auto"],
                    help="collection policy; auto picks hybrid for MoE "
                         "archs and fused otherwise")
    ap.add_argument("--rank-mode", default="uniform",
                    choices=["uniform", "adaptive"],
                    help="rank budget policy: uniform, or adaptive (global "
                         "water-filling over whitened-spectrum losses)")
    ap.add_argument("--replay-taps", default=None, choices=["auto"],
                    help="'auto' (hybrid mode): replay the groups whose "
                         "measured shift drift passes the threshold")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="save the compressed params to DIR and serve "
                         "them back through from_checkpoint")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--engine", action="store_true",
                    help="route through the continuous-batching engine")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    mode = args.calib_mode
    if mode == "auto":
        mode = "hybrid" if cfg.moe is not None and cfg.moe.num_experts \
            else "fused"
    if args.replay_taps == "auto" and mode != "hybrid":
        # drift-driven replay needs hybrid collection: promote
        print(f"[serve] --replay-taps auto: calib mode {mode!r} -> 'hybrid'")
        mode = "hybrid"
    rng = np.random.default_rng(0)
    # the stub frontends' inputs, from a seeded generator on the host
    gen = torch.Generator().manual_seed(0)

    def frontend(n):
        if cfg.frontend == "vision":
            return {"patches": 0.02 * torch.randn(
                (n, cfg.num_patches, cfg.d_model), generator=gen)}
        if cfg.frontend == "audio":
            return {"frames": 0.02 * torch.randn(
                (n, cfg.encoder_seq_len, cfg.d_model), generator=gen)}
        return {}

    params = M.init_params(cfg, 0, device=dev)
    if args.ratio < 1.0:
        calib = {"tokens": rng.integers(0, cfg.vocab_size, (8, 64)),
                 **frontend(8)}
        params, report = P.compress_model(
            params, cfg, calib,
            P.CompressConfig(ratio=args.ratio, refine_epochs=4,
                             calib_mode=mode, rank_mode=args.rank_mode,
                             replay_taps=args.replay_taps or ()),
            device=dev)
        alloc = report["calibration"]["rank_mode"]
        print(f"[serve] compressed to ratio {args.ratio}; "
              f"{len(report['units'])} blocks; calib {mode}, "
              f"{report['calibration']['tapped_forwards']} tapped forwards, "
              f"{report['calibration']['replayed_groups']} replayed groups; "
              f"ranks {alloc['mode']}"
              + (f" {alloc['min_rank']}-{alloc['max_rank']}, achieved "
                 f"ratio {alloc['achieved_ratio']:.4f}"
                 if alloc["mode"] == "adaptive" else ""))
    max_len = args.prompt_len + _prefill_extra_len(cfg) + args.steps + 8
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    extras = frontend(args.batch)
    if args.checkpoint is not None:
        CheckpointManager(args.checkpoint, async_save=False).save(
            0, params, meta={"arch": args.arch, "ratio": args.ratio})
        print(f"[serve] saved to {args.checkpoint}; serving it back")
    t0 = time.time()
    if args.engine:
        kw = dict(max_len=max_len, slots=args.batch, device=dev)
        server = (ContinuousBatchingServer.from_checkpoint(
            cfg, args.checkpoint, **kw) if args.checkpoint is not None
            else ContinuousBatchingServer(cfg, params, **kw))
        results = server.run([Request(
            rid=i, prompt=prompts[i], steps=args.steps,
            extras={k: v[i:i + 1] for k, v in extras.items()} or None)
            for i in range(args.batch)])
        toks = np.stack([results[i]["tokens"] for i in range(args.batch)])
    else:
        kw = dict(max_len=max_len, batch=args.batch, device=dev)
        server = (Server.from_checkpoint(cfg, args.checkpoint, **kw)
                  if args.checkpoint is not None
                  else Server(cfg, params, **kw))
        toks = server.generate(prompts, steps=args.steps,
                               extras=extras).cpu().numpy()
    dt = time.time() - t0
    print(f"[serve] generated {toks.shape} in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s) on {dev}")
    print(toks[:, :16])
    return toks


if __name__ == "__main__":
    main()

"""Serving driver (port of ``repro.launch.serve``): batched prefill +
greedy decode loop, optionally with the Dumpy-backed kNN-softmax head (the
paper's application integration).

The retrieval path routes through the continuous-batching front-end
(``repro_torch.serving.batching``): each decode row submits as a single
request and the front-end coalesces them into bucketed device programs
(``sax_encode`` and ``lb_paa_interval`` on the card each step) — hidden
states validate once per batch at the encode boundary.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --preset smoke --tokens 32 --knn-softmax
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

:func:`generate` is the loop; :func:`main` wraps it with the reference's
flags and printed lines.  Everything runs on ``--device`` (the card unless
``cpu`` is asked for); nothing falls back to the CPU or to the head's host
search.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.device_index import resolve_device
from repro_torch.launch.train import preset_config
from repro_torch.models import transformer as tfm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(cfg, model, tokens, n_tokens: int, *, knn_head=None,
             frontend=None, timings: dict | None = None) -> np.ndarray:
    """Greedy generation of ``n_tokens`` after the prompt ``tokens [B, P]``
    (numpy or a tensor): prefill into caches grown to ``P + n_tokens``,
    the first token from the prefill's logits, then ``n_tokens - 1``
    decode steps.  With ``knn_head`` each step's token is the head's
    choice from the step's float32 hidden rows, through ``frontend`` (its
    ``step_batch_via``).  Returns the tokens ``[B, n_tokens]`` (int32).
    ``timings``, when given, receives ``prefill_s``, ``decode_s`` and each
    decode step's seconds (``step_s``), each ending on a device read."""
    if knn_head is not None and frontend is None:
        raise ValueError("the kNN-softmax head serves through a front-end: "
                         "pass frontend=knn_head.make_frontend(...)")
    device = model.embed.device
    tokens = torch.as_tensor(tokens).to(device)
    B, P = tokens.shape
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                      device=device)
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((B, cfg.vision_tokens, cfg.d_model),
                                       device=device)
    timings = {} if timings is None else timings
    _sync(device)
    t0 = time.perf_counter()
    # prefill, then grow the attention caches to the whole conversation
    logits, cache = tfm.forward_prefill(model, batch)
    cache = tfm.grow_cache(cache, P, P + n_tokens)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    out = [tok.cpu().numpy()]
    timings["prefill_s"] = time.perf_counter() - t0
    timings["step_s"] = []
    t0 = time.perf_counter()
    for i in range(n_tokens - 1):
        t1 = time.perf_counter()
        logits, cache, hidden = tfm.forward_decode(
            model, cache, tok, P + i, return_hidden=True)
        if knn_head is not None:
            # retrieval path: Dumpy candidates from the hidden states, exact
            # logits over candidates only — one validated batch through the
            # coalescing front-end
            toks = knn_head.step_batch_via(
                frontend, hidden[:, 0, :].float().cpu().numpy())
            tok = torch.as_tensor(toks).to(device=device,
                                           dtype=torch.int32)[:, None]
        else:
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(
                torch.int32)[:, None]
        out.append(tok.cpu().numpy())
        timings["step_s"].append(time.perf_counter() - t1)
    timings["decode_s"] = time.perf_counter() - t0
    return np.concatenate(out, axis=1)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--knn-softmax", action="store_true")
    ap.add_argument("--max-wait", type=float, default=0.002,
                    help="front-end coalescing deadline (seconds)")
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (cuda unless cpu is asked)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    model = tfm.init_params(cfg, torch.Generator(device).manual_seed(0),
                            device)
    B, P = args.batch, args.prompt_len
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)

    knn_head = frontend = None
    if args.knn_softmax:
        from repro_torch.serving.knn_softmax import KnnSoftmaxHead
        knn_head = KnnSoftmaxHead(
            model.lm_head.detach().float().cpu().numpy(), th=64,
            r_candidates=64, nbr_nodes=8, device=device)
        # continuous-batching front-end: warms the bucket ladder once, then
        # every decode row is a single coalesced request
        frontend = knn_head.make_frontend(max_batch=max(B, 4),
                                          max_wait=args.max_wait)
    timings: dict = {}
    try:
        out = generate(cfg, model, tokens, args.tokens, knn_head=knn_head,
                       frontend=frontend, timings=timings)
    finally:
        if frontend is not None:
            frontend.close()
    dt = timings["decode_s"]
    print(f"prefill {P} tokens x{B}: {timings['prefill_s']:.2f}s")
    print(f"decoded {args.tokens-1} steps x{B} in {dt:.2f}s "
          f"({(args.tokens-1)*B/max(dt,1e-9):.1f} tok/s)")
    if knn_head is not None:
        s = knn_head.stats
        print(f"knn-softmax stats: recall@R="
              f"{s.exact_in_topr/max(s.tokens,1):.2f} "
              f"argmax-agree={s.agree_argmax/max(s.tokens,1):.2f}")
        print(f"frontend stats: {frontend.stats.snapshot()}")
    print("sample:", out[0][:16])


if __name__ == "__main__":
    main()

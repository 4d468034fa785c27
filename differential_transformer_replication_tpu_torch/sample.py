"""Sample text from a trained checkpoint: the port's twin of the root
``sample.py``.

Loads a training checkpoint (``best_model.ckpt``; either package's
format) or a ``save_pretrained`` directory, encodes the prompt with the
run's tokenizer (checked against the checkpoint's recorded
fingerprint), and samples: through the KV-cache decoder
(``generate_cached``) when the output fits the context window (or for
the RoPE families, which roll their cache), else through the windowed
loop on the training forward (``generate``). With ``--kv-page-size`` or
``--spec-draft-len`` (n-gram drafts), or ``--stop``, sampling runs in a
small serving engine, where the ``--n`` samples share the prompt's
pages.

    python -m differential_transformer_replication_tpu_torch.sample \\
        --checkpoint best_model.ckpt --tokenizer tokenizer \\
        --prompt "One day, " --max-new-tokens 200 --n 2

It runs on ``cuda`` unless ``--device cpu`` is given. Its output lines
are the root ``sample.py``'s; a timing line goes to stderr. Flags of
the root script that the port does not run yet are refused with the
ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# the root sample.py's flags that wait for a later slice -> the ROADMAP item
LATER_FLAGS = {
    "--quantize-weights": "int8 weights (ROADMAP Queue A: serving subsystems)",
    "--spec-draft-ckpt": "ModelDrafter (ROADMAP Queue A: serving subsystems)",
    "--json-schema": "constraints (ROADMAP Queue A: serving subsystems)",
    "--regex": "constraints (ROADMAP Queue A: serving subsystems)",
    "--choices": "constraints (ROADMAP Queue A: serving subsystems)",
    "--repetition-penalty": "penalties (ROADMAP Queue A: serving subsystems)",
    "--presence-penalty": "penalties (ROADMAP Queue A: serving subsystems)",
    "--frequency-penalty": "penalties (ROADMAP Queue A: serving subsystems)",
    "--logprobs": "logprobs (ROADMAP Queue A: serving subsystems)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m differential_transformer_replication_tpu_torch.sample",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="training checkpoint dir (best_model.ckpt) or a "
                        "save_pretrained dir")
    p.add_argument("--tokenizer", default="tokenizer",
                   help="tokenizer dir (vocab.json + merges.txt)")
    p.add_argument("--prompt", default="Once upon a time")
    p.add_argument("--max-new-tokens", type=int, default=200)
    p.add_argument("--n", type=int, default=1, help="samples to draw")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=1.0,
                   help="sampling temperature; 0 = greedy (reference: 1.0)")
    p.add_argument("--top-k", type=int, default=None,
                   help="keep only the k highest logits (reference: off)")
    p.add_argument("--no-verify-checkpoint", action="store_true",
                   help="skip integrity-manifest verification (needed "
                        "for pre-manifest checkpoints)")
    p.add_argument("--decode-attention-impl", default="",
                   choices=("", "xla", "pallas"),
                   help="only '' (the port dispatches its kernels by device)")
    p.add_argument("--kv-cache-dtype", default="",
                   choices=("", "auto", "bf16", "int8"),
                   help="KV-cache storage dtype; int8 = per-vector scaled "
                        "int8 K/V; '' keeps the checkpoint's config")
    p.add_argument("--kv-page-size", type=int, default=0,
                   help="route sampling through the serving engine's PAGED "
                        "KV cache (tokens per page, must divide block_size): "
                        "the --n samples share the prompt's prefill pages "
                        "through the prefix cache. 0 = generate_cached")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="with --kv-page-size: disable the shared-prefix "
                        "cache (each sample re-prefills)")
    p.add_argument("--prefix-cache-pages", type=int, default=0,
                   help="with --kv-page-size: extra pool pages kept as "
                        "cached-prefix headroom")
    p.add_argument("--spec-draft-len", type=int, default=0,
                   help="n-gram (prompt-lookup) draft tokens verified per "
                        "step, through the serving engine; greedy output "
                        "is the plain path's")
    p.add_argument("--stop", action="append", default=None, metavar="TEXT",
                   help="stop sequence: finish when the generated tokens "
                        "end with this string's encoding (repeatable)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def refused_flags(argv) -> list:
    return [a.split("=")[0] for a in argv if a.split("=")[0] in LATER_FLAGS]


def _engine_outputs(params, model_cfg, ids, args, tokenizer, device) -> list:
    """The engine route: the first sample prefills the prompt alone; on
    the paged pool its retirement donates the prompt's pages to the
    prefix cache, so the other ``--n - 1`` samples skip the prefill."""
    from differential_transformer_replication_tpu_torch.config import ServingConfig
    from differential_transformer_replication_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from differential_transformer_replication_tpu_torch.serving.request import (
        SamplingParams,
    )

    serving = ServingConfig(
        num_slots=max(1, min(args.n, 8)), kv_page_size=args.kv_page_size,
        prefix_cache=not args.no_prefix_cache,
        prefix_cache_pages=args.prefix_cache_pages,
        spec_mode="ngram" if args.spec_draft_len > 0 else "",
        spec_draft_len=args.spec_draft_len or 4,
        max_seq_len=(0 if model_cfg.model == "diff"
                     else len(ids) + args.max_new_tokens),
    )
    engine = ServingEngine(params, model_cfg, serving, device=device)
    stop = (tuple(tuple(tokenizer.encode(s).ids) for s in args.stop)
            if args.stop else None)

    def sp(i):
        return SamplingParams(max_new_tokens=args.max_new_tokens,
                              temperature=args.temperature, top_k=args.top_k,
                              seed=args.seed + i, stop=stop)

    outs = engine.generate([ids], params=[sp(0)])
    if args.n > 1:
        outs += engine.generate([ids] * (args.n - 1),
                                params=[sp(i) for i in range(1, args.n)])
    st = engine.page_stats()
    if st is not None:
        print(f"[sample] paged KV: page_size={st['page_size']} "
              f"prefix hits={st['hits_total']} misses={st['misses_total']}")
    spec = engine.spec_stats()
    if spec is not None:
        print(f"[sample] spec ({spec['mode']}): proposed={spec['proposed']} "
              f"accepted={spec['accepted']} rate={spec['acceptance_rate']}")
    return outs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    bad = refused_flags(argv)
    if bad:
        parser.error("; ".join(f"{f} is not run by the port yet: "
                               f"{LATER_FLAGS[f]}" for f in bad))
    args = parser.parse_args(argv)
    if args.decode_attention_impl:
        parser.error(f"--decode-attention-impl {args.decode_attention_impl}: "
                     "the port has no impl switch; it dispatches its kernels "
                     "by device")

    import torch

    from differential_transformer_replication_tpu_torch.data.tokenizer import (
        check_tokenizer_matches,
        load_tokenizer,
    )
    from differential_transformer_replication_tpu_torch.models import (
        generate,
        generate_cached,
    )
    from differential_transformer_replication_tpu_torch.train.checkpoint import (
        from_pretrained,
        load_params_for_inference,
    )
    from differential_transformer_replication_tpu_torch.train.trainer import (
        resolve_device,
    )

    device = resolve_device(args.device)
    fp = None  # save_pretrained dirs carry no meta.json / fingerprint
    if os.path.exists(os.path.join(args.checkpoint, "params.msgpack")):
        params, model_cfg = from_pretrained(args.checkpoint, device=device)
    else:
        params, model_cfg, meta = load_params_for_inference(
            args.checkpoint, verify=not args.no_verify_checkpoint,
            device=device)
        fp = meta.get("tokenizer_fingerprint")
    if args.kv_cache_dtype:
        model_cfg = model_cfg.replace(kv_cache_dtype=args.kv_cache_dtype)

    tokenizer = load_tokenizer(args.tokenizer)
    # a tokenizer that cannot belong to the checkpoint fails loud here
    # instead of decoding gibberish
    check_tokenizer_matches(tokenizer, model_cfg.vocab_size, fp,
                            context=args.checkpoint)
    ids = tokenizer.encode(args.prompt).ids
    if not ids:
        raise SystemExit("prompt encoded to zero tokens")
    if len(ids) > model_cfg.block_size:
        ids = ids[-model_cfg.block_size:]

    in_window = len(ids) + args.max_new_tokens <= model_cfg.block_size
    rolls = in_window or model_cfg.model != "diff"
    engine_route = args.kv_page_size > 0 or args.spec_draft_len > 0 or bool(args.stop)
    t0 = time.perf_counter()
    if engine_route and rolls:
        outs = _engine_outputs(params, model_cfg, ids, args, tokenizer, device)
        route = "engine"
        rows = [o.prompt + o.tokens for o in outs]
        new = sum(len(o.tokens) for o in outs)
        heads = [f"--- sample {i} ({o.finish_reason}) ---"
                 for i, o in enumerate(outs)]
    else:
        if args.stop:
            raise SystemExit(
                "--stop runs in the serving engine, which the diff family "
                "past its context window cannot route through — shorten "
                "--max-new-tokens to fit block_size or use the "
                "control/ndiff families")
        # in the window, or a RoPE family rolling its cache: one prefill
        # and a decode step a token; the diff family past its window
        # recomputes a full window a token
        gen_fn, route = ((generate_cached, "generate_cached") if rolls
                         else (generate, "generate"))
        idx = torch.tensor([ids] * args.n, dtype=torch.int64, device=device)
        out = gen_fn(params, idx, model_cfg, args.max_new_tokens, args.seed,
                     temperature=args.temperature, top_k=args.top_k)
        rows = out.cpu().tolist()
        new = args.n * args.max_new_tokens
        heads = [f"--- sample {i} ---" for i in range(len(rows))]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for head, row in zip(heads, rows):
        print(head)
        print(tokenizer.decode(row))
    print(f"[sample] {new} new tokens through {route} in {dt:.3f} s "
          f"({new / max(dt, 1e-9):.1f} tokens/s) on {device}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

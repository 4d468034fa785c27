"""Sample text from a trained checkpoint: the port's twin of the root
``sample.py``.

Loads a training checkpoint (``best_model.ckpt``; either package's
format) or a ``save_pretrained`` directory, encodes the prompt with the
run's tokenizer (checked against the checkpoint's recorded
fingerprint), and samples: through the KV-cache decoder
(``generate_cached``) when the output fits the context window (or for
the RoPE families, which roll their cache), else through the windowed
loop on the training forward (``generate``). With ``--kv-page-size``,
speculation (``--spec-draft-ckpt``, a drafter checkpoint, or
``--spec-draft-len`` alone, n-gram drafts), ``--stop``, a constraint
(``--json-schema``, ``--regex``, ``--choices``), a penalty or
``--logprobs``, sampling runs in a small serving engine, where the
``--n`` samples share the prompt's pages. ``--quantize-weights int8``
quantizes and dequantizes every matmul weight at load (the drafter's
too).

    python -m differential_transformer_replication_tpu_torch.sample \\
        --checkpoint best_model.ckpt --tokenizer tokenizer \\
        --prompt "One day, " --max-new-tokens 200 --n 2

It runs on ``cuda`` unless ``--device cpu`` is given. Its output lines
are the root ``sample.py``'s; a timing line goes to stderr. The root
script's ``--decode-attention-impl pallas``/``xla`` is refused: the port
dispatches its kernels by device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# the root sample.py's flags that wait for a later slice -> the ROADMAP item
# (none: every flag of the root script runs)
LATER_FLAGS: dict = {}


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
    p.add_argument("--quantize-weights", default=None, choices=("int8",),
                   help="per-channel int8 quantize + dequant of every "
                        "matmul weight on load (embeddings and norms stay "
                        "exact)")
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
    p.add_argument("--spec-draft-ckpt", default=None,
                   help="speculative decoding with a small drafter "
                        "checkpoint (same tokenizer), loaded through the "
                        "same verified path as --checkpoint "
                        "(--no-verify-checkpoint and --quantize-weights "
                        "apply to it); sampling then runs in the engine")
    p.add_argument("--spec-draft-len", type=int, default=0,
                   help="draft tokens verified per step; > 0 without "
                        "--spec-draft-ckpt drafts by n-gram lookup. Greedy "
                        "output is the plain path's")
    p.add_argument("--json-schema", default=None,
                   help="constrain output to JSON matching this schema "
                        "(JSON text, or a path to a .json file); runs in "
                        "the serving engine")
    p.add_argument("--regex", default=None,
                   help="constrain output to match this regular expression "
                        "(at most one of --json-schema / --regex / "
                        "--choices)")
    p.add_argument("--choices", action="append", default=None,
                   metavar="TEXT",
                   help="constrain output to exactly one of these strings "
                        "(repeatable)")
    p.add_argument("--repetition-penalty", type=float, default=1.0,
                   help="divide positive / multiply negative logits of "
                        "already-generated tokens (1.0 = off)")
    p.add_argument("--presence-penalty", type=float, default=0.0,
                   help="flat logit subtraction for any token already "
                        "generated (0 = off)")
    p.add_argument("--frequency-penalty", type=float, default=0.0,
                   help="logit subtraction scaled by each token's "
                        "generated count (0 = off)")
    p.add_argument("--logprobs", type=int, default=0,
                   help="echo the chosen token's logprob plus the top-N "
                        "alternatives per generated token (engine route)")
    p.add_argument("--stop", action="append", default=None, metavar="TEXT",
                   help="stop sequence: finish when the generated tokens "
                        "end with this string's encoding (repeatable)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def refused_flags(argv) -> list:
    return [a.split("=")[0] for a in argv if a.split("=")[0] in LATER_FLAGS]


def _engine_outputs(params, model_cfg, ids, args, tokenizer, device,
                    schema=None, drafter=None) -> list:
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

    spec_mode = ("model" if drafter is not None
                 else "ngram" if args.spec_draft_len > 0 else "")
    serving = ServingConfig(
        num_slots=max(1, min(args.n, 8)), kv_page_size=args.kv_page_size,
        prefix_cache=not args.no_prefix_cache,
        prefix_cache_pages=args.prefix_cache_pages,
        spec_mode=spec_mode, spec_draft_len=args.spec_draft_len or 4,
        max_seq_len=(0 if model_cfg.model == "diff"
                     else len(ids) + args.max_new_tokens),
    )
    constrained = bool(schema or args.regex or args.choices)
    vocab = None
    if constrained:
        # the FSM compiler walks the id -> decoded-text table
        from differential_transformer_replication_tpu_torch.data.tokenizer import (
            vocab_strings,
        )

        vocab = vocab_strings(tokenizer, model_cfg.vocab_size)
    engine = ServingEngine(params, model_cfg, serving, device=device,
                           spec_drafter=drafter, vocab=vocab)
    stop = (tuple(tuple(tokenizer.encode(s).ids) for s in args.stop)
            if args.stop else None)

    def sp(i):
        return SamplingParams(
            max_new_tokens=args.max_new_tokens, temperature=args.temperature,
            top_k=args.top_k, seed=args.seed + i, stop=stop,
            json_schema=schema, regex=args.regex,
            choices=tuple(args.choices) if args.choices else None,
            repetition_penalty=args.repetition_penalty,
            presence_penalty=args.presence_penalty,
            frequency_penalty=args.frequency_penalty, logprobs=args.logprobs)

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
    if constrained:
        cs = engine.constrain_stats()
        print(f"[sample] constrained: cache entries={cs['entries']} "
              f"hits={cs['hits_total']} misses={cs['misses_total']}")
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
        params, model_cfg = from_pretrained(
            args.checkpoint, quantize=args.quantize_weights, device=device)
    else:
        params, model_cfg, meta = load_params_for_inference(
            args.checkpoint, verify=not args.no_verify_checkpoint,
            quantize=args.quantize_weights, device=device)
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
    schema = args.json_schema
    if schema and os.path.exists(schema):  # the path form: read the file
        with open(schema) as f:
            schema = f.read()
    # the logit pipeline (constraints, penalties, the logprob echo) and
    # stop sequences live in the serving engine
    pipeline = bool(schema or args.regex or args.choices or args.stop
                    or args.logprobs > 0 or args.repetition_penalty != 1.0
                    or args.presence_penalty != 0.0
                    or args.frequency_penalty != 0.0)
    engine_route = (args.kv_page_size > 0 or args.spec_draft_len > 0
                    or bool(args.spec_draft_ckpt) or pipeline)
    t0 = time.perf_counter()
    if engine_route and rolls:
        drafter = None
        if args.spec_draft_ckpt:
            # the drafter loads through the target's verified path, with
            # the same weight quantization
            d_params, d_cfg, _ = load_params_for_inference(
                args.spec_draft_ckpt, verify=not args.no_verify_checkpoint,
                quantize=args.quantize_weights, device=device)
            drafter = (d_params, d_cfg)
        outs = _engine_outputs(params, model_cfg, ids, args, tokenizer, device,
                               schema=schema, drafter=drafter)
        route = "engine"
        rows = [o.prompt + o.tokens for o in outs]
        new = sum(len(o.tokens) for o in outs)
        heads = [f"--- sample {i} ({o.finish_reason}) ---"
                 for i, o in enumerate(outs)]
        lps = [o.token_logprobs for o in outs]
    else:
        if pipeline:
            raise SystemExit(
                "--json-schema/--regex/--choices/--stop/--logprobs and the "
                "penalty flags run in the serving engine's logit pipeline, "
                "which the diff family past its context window cannot "
                "route through — shorten --max-new-tokens to fit "
                "block_size or use the control/ndiff families")
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
        lps = [None] * len(rows)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for head, row, lp in zip(heads, rows, lps):
        print(head)
        print(tokenizer.decode(row))
        if lp is not None:
            print("    logprobs: " + " ".join(f"{v:.3f}" for v in lp))
    print(f"[sample] {new} new tokens through {route} in {dt:.3f} s "
          f"({new / max(dt, 1e-9):.1f} tokens/s) on {device}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

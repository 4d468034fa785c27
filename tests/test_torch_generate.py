"""The port's generators, ``sample`` command line and text prompts against
the JAX package's, on the CPU.

Both sides start from the same JAX-initialized params (lambda vectors
perturbed away from zero, the lm head scaled up so greedy choices are
not near-ties), handed to the port through ``params.py``. The JAX
``generate`` runs its training forward as the plain reference
(``attention_impl="xla"``); the JAX ``generate_cached`` runs its fused
decode step with the Pallas kernels interpreted (``ffn_impl`` and
``decode_attention_impl`` "pallas"), as ``tests/test_torch_decode.py``
runs them; the port's wrappers run their plain versions because the
tensors lie on the CPU. Greedy tokens must be equal for control, diff
and ndiff at 2 layers in fp32: in the window, past it (diff, windowed)
and past ``block_size`` (RoPE, cached). Sampled tokens come from a
``torch.Generator`` and differ from JAX's by design; they must be a
function of the seed, and ``top_k`` keeps ties at its k-th value.
"""

from __future__ import annotations

import importlib
import json
import runpy
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.models.decode import (
    generate_cached as j_generate_cached,
)
from differential_transformer_replication_tpu.models.generate import (
    generate as j_generate,
)
from differential_transformer_replication_tpu.models.generate import (
    sample_token as j_sample_token,
)
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.data import tokenizer as ptok
from differential_transformer_replication_tpu_torch.data.corpus import synthetic_corpus
from differential_transformer_replication_tpu_torch.models import (
    generate,
    generate_cached,
    init_model,
    sample_token,
)
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.serving.engine import ServingEngine
from differential_transformer_replication_tpu_torch.serving.server import (
    ServingClient,
    serve,
)

# the module (the package's ``generate`` attribute is the function)
pgen = importlib.import_module(
    "differential_transformer_replication_tpu_torch.models.generate")
REPO = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=61, n_embd=32, n_head=2, n_layer=2, block_size=32,
             dropout=0.0, n_terms=3, compute_dtype="float32")
MIN_GAP = 1e-3  # the port's smallest top-2 logit gap along a greedy path


def _setup(kind: str, seed: int = 0, **over):
    jcfg = JModelConfig(model=kind, **{**SMALL, **over})
    tcfg = ModelConfig(model=kind, **{**SMALL, **over})
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    for blk in tree["blocks"]:
        for key in ("lambda_q", "lambda_k"):
            if key in blk["attn"]:
                blk["attn"][key] = (rng.standard_normal(blk["attn"][key].shape)
                                    * 0.1).astype(np.float32)
    tree["lm_head"] = jax.tree_util.tree_map(lambda a: a * 40.0, tree["lm_head"])
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_jax(tree, tcfg, device="cpu")


def _prompts(B: int, T0: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"],
                                                size=(B, T0)).astype(np.int32)


def _gaps(monkeypatch) -> list:
    """Record the top-2 gap of every greedy step the port takes."""
    gaps = []
    real = pgen.sample_token

    def spy(gen, logits, temperature=1.0, top_k=None):
        top = torch.topk(logits, 2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))
        return real(gen, logits, temperature, top_k)

    monkeypatch.setattr(pgen, "sample_token", spy)
    return gaps


# (family, B, prompt length, new tokens): in the window; the diff family
# past its window (windowed route only); RoPE families past block_size
# and from a prompt longer than block_size (cached route only)
GENERATE_CASES = [("control", 2, 5, 12), ("diff", 2, 5, 12), ("ndiff", 2, 5, 12),
                  ("diff", 2, 10, 30), ("control", 1, 30, 8)]
CACHED_CASES = [("control", 2, 5, 20), ("diff", 2, 5, 20), ("ndiff", 2, 5, 20),
                ("control", 2, 10, 40), ("ndiff", 1, 10, 40), ("control", 1, 40, 8)]


@pytest.mark.parametrize("kind,B,T0,new", GENERATE_CASES)
def test_generate_greedy_equals_jax(kind, B, T0, new, monkeypatch):
    jcfg, tcfg, jparams, tparams = _setup(kind)
    idx = _prompts(B, T0, seed=T0)
    want = np.asarray(j_generate(jparams, jnp.asarray(idx), jcfg, new,
                                 jax.random.PRNGKey(0), temperature=0.0))
    gaps = _gaps(monkeypatch)
    got = generate(tparams, torch.from_numpy(idx).to(torch.int64), tcfg, new,
                   0, temperature=0.0)
    assert got.shape == (B, T0 + new) and len(gaps) == new
    assert min(gaps) > MIN_GAP, min(gaps)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,B,T0,new", CACHED_CASES)
def test_generate_cached_greedy_equals_jax(kind, B, T0, new, monkeypatch):
    jcfg, tcfg, jparams, tparams = _setup(kind)
    jcfg = jcfg.replace(ffn_impl="pallas", decode_attention_impl="pallas")
    idx = _prompts(B, T0, seed=T0 + 1)
    want = np.asarray(j_generate_cached(jparams, jnp.asarray(idx), jcfg, new,
                                        jax.random.PRNGKey(0), temperature=0.0))
    gaps = _gaps(monkeypatch)
    got = generate_cached(tparams, torch.from_numpy(idx).to(torch.int64), tcfg,
                          new, 0, temperature=0.0)
    assert got.shape == (B, T0 + new) and len(gaps) == new
    assert min(gaps) > MIN_GAP, min(gaps)
    assert np.array_equal(got.numpy(), want)


def test_generate_cached_keeps_the_diff_window_guard():
    jcfg, tcfg, jparams, tparams = _setup("diff")
    idx = _prompts(1, 20, seed=3)
    with pytest.raises(ValueError) as want:
        j_generate_cached(jparams, jnp.asarray(idx), jcfg, 13, jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as got:
        generate_cached(tparams, torch.from_numpy(idx).to(torch.int64), tcfg, 13)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="prompt length"):
        generate(tparams, torch.zeros((1, 33), dtype=torch.int64), tcfg, 2)


def test_sample_token_greedy_and_top_k_ties_equal_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 50)).astype(np.float32)
    logits[0, [3, 9]] = 10.0  # a tie at the top: the first index wins
    for k in (None, 0, 1, 5, 50, 80):
        want = np.asarray(j_sample_token(jax.random.PRNGKey(0), jnp.asarray(logits),
                                         0.0, k))
        got = sample_token(torch.Generator(), torch.from_numpy(logits), 0.0, k)
        assert np.array_equal(got.numpy(), want), k
    # ties at the k-th value are kept: k = 2 keeps all three 3.0s
    row = torch.tensor([[0.0, 3.0, 3.0, 3.0, 1.0, 2.0]]).repeat(400, 1)
    gen = torch.Generator()
    gen.manual_seed(1)
    drawn = set(sample_token(gen, row, 1.0, 2).tolist())
    assert drawn == {1, 2, 3}
    # the JAX mask keeps the same set (its draw is another stream)
    jdrawn = set(np.asarray(j_sample_token(jax.random.PRNGKey(1), jnp.asarray(
        row.numpy()), 1.0, 2)).tolist())
    assert jdrawn <= {1, 2, 3}


@pytest.mark.parametrize("route", ["generate", "generate_cached"])
def test_sampled_tokens_are_a_function_of_the_seed(route):
    _, tcfg, _, tparams = _setup("ndiff")
    fn = generate if route == "generate" else generate_cached
    idx = torch.from_numpy(_prompts(2, 4, seed=9)).to(torch.int64)
    a = fn(tparams, idx, tcfg, 16, 5, temperature=1.5)
    b = fn(tparams, idx, tcfg, 16, 5, temperature=1.5)
    c = fn(tparams, idx, tcfg, 16, 6, temperature=1.5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :4], idx)
    # top_k = 1 is greedy whatever the temperature and seed
    assert torch.equal(fn(tparams, idx, tcfg, 8, 3, temperature=2.0, top_k=1),
                       fn(tparams, idx, tcfg, 8, 4, temperature=0.0))


# ---------------------------------------------------------------------------
# the command lines: the port's sample against the root sample.py on a
# checkpoint and tokenizer the JAX trainer wrote; the server's text prompts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A tiny diff run of the JAX trainer from the synthetic corpus: its
    best checkpoint (with the tokenizer fingerprint) and tokenizer dir."""
    from differential_transformer_replication_tpu.config import (
        TrainConfig as JTrainConfig,
    )
    from differential_transformer_replication_tpu.train.trainer import (
        train as j_train,
    )

    tmp = tmp_path_factory.mktemp("jax_run")
    jcfg = JTrainConfig(
        model=JModelConfig(model="diff", n_embd=32, n_head=2, n_layer=2,
                           block_size=16, compute_dtype="float32"),
        dataset="synthetic", num_train_samples=200, vocab_size=12000,
        tokenizer_dir=str(tmp / "tok"), checkpoint_path=str(tmp / "best.ckpt"),
        last_checkpoint_path=str(tmp / "last.ckpt"), metrics_path=None,
        micro_batch_size=8, max_iters=30, eval_interval=30, eval_iters=1,
        log_interval=30, learning_rate=1e-2, min_lr=1e-3, warmup_iters=2, seed=3)
    j_train(jcfg)
    return tmp


def _root_sample(argv, capsys) -> str:
    old = sys.argv
    sys.argv = ["sample.py", *argv]
    try:
        runpy.run_path(str(REPO / "sample.py"), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


@pytest.mark.parametrize("prompt,new,extra,route", [
    ("One day, Tom", 8, [], "generate_cached"),
    ("One day, Tom saw", 20, [], "generate"),  # past the window of 16
    ("One day, Tom", 8, ["--kv-page-size", "8"], "engine"),  # paged, prefix hits
    ("One day, Tom", 8, ["--spec-draft-len", "3", "--stop", "."], "engine"),
    ("One day, Tom", 8, ["--quantize-weights", "int8"], "generate_cached"),
    ("One day, Tom", 6, ["--regex", "[a-z ]+", "--logprobs", "2",
                         "--presence-penalty", "1.0"], "engine"),
    # a model drafter: the run's own checkpoint, int8 like the target
    ("One day, Tom", 6, ["--spec-draft-ckpt", "RUN", "--quantize-weights", "int8",
                         "--choices", " saw", "--choices", " went"], "engine"),
])
def test_sample_cli_prints_the_root_sample_text(jax_run, capsys, prompt, new,
                                                extra, route):
    from differential_transformer_replication_tpu_torch import sample

    argv = ["--checkpoint", str(jax_run / "best.ckpt"), "--tokenizer",
            str(jax_run / "tok"), "--prompt", prompt, "--max-new-tokens",
            str(new), "--temperature", "0", "--n", "2",
            *[str(jax_run / "best.ckpt") if a == "RUN" else a for a in extra]]
    want = _root_sample(argv, capsys)
    assert sample.main([*argv, "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert captured.out == want and want.count("--- sample") == 2
    assert f"through {route} in" in captured.err


def test_sample_cli_refuses_what_the_port_does_not_run(jax_run, capsys):
    from differential_transformer_replication_tpu_torch import sample

    base = ["--checkpoint", str(jax_run / "best.ckpt"), "--tokenizer",
            str(jax_run / "tok"), "--device", "cpu"]
    # every flag of the root script runs (the parity cases above) but
    # the impl switch: the port dispatches its kernels by device
    assert sample.LATER_FLAGS == {} and sample.refused_flags(
        ["--quantize-weights=int8", "--regex", "--logprobs"]) == []
    for extra, needle in ((["--decode-attention-impl", "pallas"], "by device"),):
        with pytest.raises(SystemExit):
            sample.main(base + extra)
        assert needle in capsys.readouterr().err
    # a tokenizer of the checkpoint's size but other content is refused
    other = jax_run / "other_tok"
    ptok.train_bpe_tokenizer(synthetic_corpus(200, seed=11), 12000, 2, str(other))
    with pytest.raises(SystemExit, match="fingerprint"):
        sample.main(base[:2] + ["--tokenizer", str(other), "--device", "cpu"])


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def _start(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}/generate", t


def _reply_or_error(url, body):
    try:
        return 200, _post(url, body)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


@pytest.mark.parametrize("with_tokenizer", [True, False])
def test_server_answers_text_prompts_with_a_tokenizer(tmp_path, with_tokenizer):
    """The port's server against the JAX package's, both in this process
    on the same JAX-initialized params: the JAX server with the HF
    tokenizer it trained, the port's with its own load of the same
    files. Text and token requests get equal ``prompt_ids``, ``tokens``
    and ``text`` from both; without a tokenizer both refuse a text
    prompt with the same 400 reply."""
    from differential_transformer_replication_tpu.config import (
        ServingConfig as JServingConfig,
    )
    from differential_transformer_replication_tpu.data import tokenizer as jtok
    from differential_transformer_replication_tpu.serving.engine import (
        ServingEngine as JServingEngine,
    )
    from differential_transformer_replication_tpu.serving.server import (
        ServingClient as JServingClient,
    )
    from differential_transformer_replication_tpu.serving.server import (
        serve as j_serve,
    )

    jt = jtok.train_bpe_tokenizer(synthetic_corpus(200), 12000, 2, str(tmp_path))
    tok = ptok.load_tokenizer(str(tmp_path))
    jcfg, cfg, jparams, params = _setup("diff", vocab_size=jt.get_vocab_size(),
                                        block_size=64)
    serving = dict(num_slots=2, prefill_chunk=16, prefill_budget=32)
    texts = ["One day, Tom saw a cat.", "The dog was very", "Mia and Ben"]
    clients = [JServingClient(JServingEngine(jparams, jcfg, JServingConfig(**serving))),
               ServingClient(ServingEngine(params, cfg, ServingConfig(**serving),
                                           device="cpu"))]
    servers = [j_serve(clients[0], port=0, tokenizer=jt if with_tokenizer else None),
               serve(clients[1], port=0, tokenizer=tok if with_tokenizer else None)]
    (jurl, jt_thread), (url, t_thread) = _start(servers[0]), _start(servers[1])
    try:
        bodies = [{"prompt": text, "max_new_tokens": 6, "temperature": 0.0}
                  for text in texts]
        bodies.append({"prompt_ids": tok.encode(texts[0]).ids,
                       "max_new_tokens": 6, "temperature": 0.0})
        for body in bodies:
            (jcode, want), (code, got) = (_reply_or_error(jurl, body),
                                          _reply_or_error(url, body))
            if not with_tokenizer and "prompt" in body:
                assert code == jcode == 400
                got.pop("trace_id"), want.pop("trace_id")  # random per request
                assert got == want and "tokenizer" in got["error"]
                continue
            assert code == jcode == 200, (got, want)
            keys = ("prompt_ids", "tokens", "finish_reason") + (
                ("text",) if with_tokenizer else ())
            assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
            assert ("text" in got) == ("text" in want) == with_tokenizer
            if "prompt" in body:
                assert got["prompt_ids"] == jt.encode(body["prompt"]).ids
            if with_tokenizer:
                assert got["text"] == jt.decode(got["tokens"])
    finally:
        for httpd, client, t in zip(servers, clients, (jt_thread, t_thread)):
            httpd.shutdown()
            httpd.server_close()
            client.close()
            t.join(timeout=30)


def test_server_main_refuses_a_tokenizer_of_another_run(jax_run, tmp_path,
                                                        monkeypatch):
    from differential_transformer_replication_tpu_torch.serving import server

    other = tmp_path / "other"
    ptok.train_bpe_tokenizer(synthetic_corpus(200, seed=11), 12000, 2, str(other))
    monkeypatch.setattr(sys, "argv", [
        "server", "--checkpoint", str(jax_run / "best.ckpt"), "--tokenizer",
        str(other), "--device", "cpu", "--port", "0"])
    with pytest.raises(SystemExit, match="fingerprint"):
        server.main()

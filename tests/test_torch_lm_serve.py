"""The port's LM serving engine and its `lm_serve` twin against the JAX
package, on the CPU.

* `ServeEngine` on `qwen1.5-4b-smoke` from the reference's parameters:
  greedy tokens equal to the reference engine's token for token (5
  requests over 3 slots, so slots are recycled); in a mixed run the
  greedy requests' tokens equal the reference's and the sampled ones
  repeat under the same `rng_seed`.
* The reference's KV gap, pinned in both packages: `admit` records the
  prompt + 1 as a slot's length and `step` sets the cache to it, so the
  first decode writes at position P + 1; the engine's greedy tokens then
  differ from a prefill -> decode_step loop, and the port's equal the
  reference's.
* The twin: `main(["--device", "cpu", ...])` returns 0, its requests are
  the example's, and served from the reference's parameters its greedy
  requests equal the reference engine's.
* Device rule and exports: the engine and the twin need a card unless
  given the CPU; `repro_torch.serve` exports `ServeEngine` and `Request`
  lazily and its import loads no torch.
* The other families behind the engine (granite-moe-3b-a800m, rwkv6-3b
  and zamba2-1.2b smoke configs): greedy tokens equal to the reference
  engine's at 1 and 4 slots, and pinned on one prompt; the batch cache
  after `admit` and after a step equal to the reference engine's, leaf
  by leaf (the reference's splice: every leaf whose axis 1 is the slot
  axis); the KV gap on zamba2's shared attention, and none on rwkv6
  (no KV cache); Whisper refused in both (its prefill needs the audio,
  which the engine does not pass); the twin at `--arch`.

The engine's and the LM attention's tests on the card are in
`tests/test_torch_cuda.py`, which imports no JAX.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import build_model as j_build_model
from repro.models.registry import get_config as j_get_config
from repro.nn.module import split_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.models.registry import build_model, get_config
from repro_torch.nn.layers import init_params, load_jax_lm_params
from repro_torch.orchestration import lm_serve
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_lm_families import close_cache

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-4b-smoke"
FAMILY_ARCHS = ["granite-moe-3b-a800m-smoke", "rwkv6-3b-smoke",
                "zamba2-1.2b-smoke"]
_TREE = {}


def tree(arch=ARCH):
    """The reference's seed-0 parameters of `arch` as numpy."""
    if arch not in _TREE:
        model = j_build_model(j_get_config(arch))
        _TREE[arch] = jax.tree_util.tree_map(
            np.asarray, split_params(model.init(jax.random.PRNGKey(0)))[0])
    return _TREE[arch]


def prompts(n, length=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, length).astype(np.int32) for _ in range(n)]


def serve_both(temps, n_slots=3, max_len=64, new=6, rng_seed=0, arch=ARCH):
    ps = prompts(len(temps))
    ref = JServeEngine(j_get_config(arch), tree(arch), n_slots=n_slots,
                       max_len=max_len).run(
        [JRequest(prompt=p, max_new_tokens=new, temperature=t)
         for p, t in zip(ps, temps)])
    port = ServeEngine(get_config(arch), tree(arch), n_slots=n_slots,
                       max_len=max_len, rng_seed=rng_seed,
                       device="cpu").run(
        [Request(prompt=p, max_new_tokens=new, temperature=t)
         for p, t in zip(ps, temps)])
    return ref, port


@pytest.mark.parametrize("n_slots", [1, 3, 5])
def test_greedy_tokens_equal_the_reference_engine(n_slots):
    ref, port = serve_both([0.0] * 5, n_slots=n_slots)
    assert len(port) == len(ref) == 5
    assert all(r.done and len(r.generated) >= 6 for r in port)
    assert [r.generated for r in port] == [r.generated for r in ref]


def test_mixed_run_greedy_equal_and_sampling_repeats():
    temps = [0.0, 0.8, 0.0, 0.8, 0.0]
    ref, port = serve_both(temps)
    _, again = serve_both(temps)
    _, other = serve_both(temps, rng_seed=1)
    for t, r, p, a in zip(temps, ref, port, again):
        assert len(p.generated) == len(r.generated) == 6
        assert p.generated == a.generated  # the same rng_seed repeats
        if t == 0.0:
            assert p.generated == r.generated
    assert all(0 <= tok < 256 for p in port for tok in p.generated)
    sampled = [p.generated for t, p in zip(temps, port) if t > 0]
    assert sampled != [p.generated for t, p in zip(temps, other) if t > 0]


def test_engine_splices_prefill_into_its_slot_and_recycles():
    engine = ServeEngine(get_config(ARCH), tree(), n_slots=2, max_len=32,
                         device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=3) for p in prompts(3)]
    assert engine.admit(reqs[0]) and engine.admit(reqs[1])
    assert not engine.admit(reqs[2])  # no free slot
    assert list(engine.slot_len) == [9, 9]
    out, cache1 = engine.model.prefill(
        torch.as_tensor(reqs[1].prompt.astype(np.int64))[None], max_len=32)
    assert torch.equal(engine.cache.k[:, 1:2], cache1.k)
    while engine.step():
        pass
    assert engine.admit(reqs[2])  # slot 0 recycled
    assert engine.slot_req[0] is reqs[2]


def manual_greedy(prefill, decode, argmax, prompt, n):
    """Prefill (into a cache longer than the prompt: at max_len == P the
    first write would clamp onto position P - 1), then decode_step at the
    cache's own length (no gap)."""
    out, cache = prefill(prompt)
    toks = [argmax(out)]
    for _ in range(n - 1):
        out, cache = decode(toks[-1], cache)
        toks.append(argmax(out))
    return toks


def test_reference_kv_gap_is_pinned_in_both_packages():
    """ROADMAP.md queue 3 item 5: the engine leaves position P of every
    slot a zero row inside the length mask (repro/serve/engine.py:77,
    92-94), so for a KV-cache model its greedy tokens leave the
    prefill -> decode_step path; the port keeps the reference's
    bookkeeping and so its tokens."""
    params = tree()
    prompt = np.random.default_rng(1).integers(0, 256, 8).astype(np.int32)
    ref = JServeEngine(j_get_config(ARCH), params, n_slots=1,
                       max_len=64).run([JRequest(prompt=prompt,
                                                 max_new_tokens=6)])
    port = ServeEngine(get_config(ARCH), params, n_slots=1, max_len=64,
                       device="cpu").run([Request(prompt=prompt,
                                                  max_new_tokens=6)])
    jm = j_build_model(j_get_config(ARCH))
    j_manual = manual_greedy(
        lambda p: jm.prefill(params, jnp.asarray(p)[None], max_len=64),
        lambda t, c: jm.decode_step(params, jnp.asarray([[t]], jnp.int32),
                                    c),
        lambda o: int(jnp.argmax(o.logits[0, -1])), prompt, 6)
    tm = load_jax_lm_params(build_model(get_config(ARCH), "cpu"), params)
    with torch.no_grad():
        t_manual = manual_greedy(
            lambda p: tm.prefill(torch.as_tensor(p.astype(np.int64))[None],
                                 max_len=64),
            lambda t, c: tm.decode_step(torch.tensor([[t]]), c),
            lambda o: int(torch.argmax(o.logits[0, -1])), prompt, 6)
    assert ref[0].generated == port[0].generated == [239, 144, 229, 5, 32, 5]
    assert j_manual == t_manual == [239, 144, 229, 5, 155, 59]


def test_twin_main_on_the_cpu(capsys):
    assert lm_serve.main(["--device", "cpu", "--requests", "5",
                          "--new-tokens", "6"]) == 0
    out = capsys.readouterr().out
    assert "served 5 requests, 30 tokens" in out and "on cpu" in out
    assert out.rstrip().endswith("lm_serve OK")


def test_twin_serves_the_examples_requests_like_the_reference():
    """The example's requests (its prompts and temperatures) through the
    twin's engine settings from the reference's parameters: the greedy
    requests equal the reference engine's."""
    cfg = get_config(ARCH)
    port_reqs = lm_serve.requests(cfg, 6, 16)
    rng = np.random.default_rng(0)  # examples/lm_serve.py:29-34
    for i, r in enumerate(port_reqs):
        assert np.array_equal(r.prompt, rng.integers(0, cfg.vocab_size, 12)
                              .astype(np.int32))
        assert r.temperature == (0.0 if i % 2 == 0 else 0.8)
    done, _, name = lm_serve.run(ARCH, 6, 16, device="cpu", params=tree())
    ref = JServeEngine(j_get_config(ARCH), tree(), n_slots=lm_serve.N_SLOTS,
                       max_len=lm_serve.MAX_LEN).run(
        [JRequest(prompt=r.prompt, max_new_tokens=16,
                  temperature=r.temperature)
         for r in lm_serve.requests(cfg, 6, 16)])
    assert name == "cpu" and len(done) == 6
    for p, r in zip(done, ref):
        if p.temperature == 0.0:
            assert p.generated == r.generated


# ---------------------------------------------------------------------------
# the other families behind the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("n_slots", [1, 4])
def test_family_greedy_tokens_equal_the_reference_engine(arch, n_slots):
    ref, port = serve_both([0.0] * 5, n_slots=n_slots, arch=arch)
    assert len(port) == len(ref) == 5
    assert all(r.done and len(r.generated) >= 6 for r in port)
    assert [r.generated for r in port] == [r.generated for r in ref]


@pytest.mark.parametrize("arch,want", [
    ("granite-moe-3b-a800m-smoke", [85, 87, 0, 83]),
    ("zamba2-1.2b-smoke", [179, 214, 136, 152]),
    ("rwkv6-3b-smoke", [51, 209, 26, 87])])
def test_family_engine_tokens_are_pinned(arch, want):
    """Prompt arange(5) + 3, 4 greedy tokens, 2 slots x 64, from the
    reference's seed-0 parameters: the same tokens in both packages."""
    prompt = (np.arange(5) + 3).astype(np.int32)
    [ref] = JServeEngine(j_get_config(arch), tree(arch), n_slots=2,
                         max_len=64).run([JRequest(prompt=prompt,
                                                   max_new_tokens=4)])
    [port] = ServeEngine(get_config(arch), tree(arch), n_slots=2,
                         max_len=64, device="cpu").run(
        [Request(prompt=prompt, max_new_tokens=4)])
    assert ref.generated == port.generated == want


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_cache_after_admit_equals_the_reference_engines(arch):
    """Two requests admitted into 3 slots, then one step: every leaf of
    the port's batch cache equals the reference engine's (slot 2 still
    zeros)."""
    ref = JServeEngine(j_get_config(arch), tree(arch), n_slots=3,
                       max_len=32)
    port = ServeEngine(get_config(arch), tree(arch), n_slots=3, max_len=32,
                       device="cpu")
    for p in prompts(2, seed=3):
        assert ref.admit(JRequest(prompt=p, max_new_tokens=4))
        assert port.admit(Request(prompt=p, max_new_tokens=4))
    assert list(port.slot_len) == list(ref.slot_len)
    close_cache(port.cache, ref.cache)
    leaves = [f for f in ref.cache._fields
              if getattr(ref.cache, f).ndim >= 2]
    assert leaves and all(
        not getattr(port.cache, f)[:, 2].any() for f in leaves)
    ref.step()
    port.step()
    assert [r.generated for r in port.slot_req if r] == \
        [r.generated for r in ref.slot_req if r]
    close_cache(port.cache, ref.cache)


@pytest.mark.parametrize("arch,engine,manual", [
    ("zamba2-1.2b-smoke", [224, 196, 182, 144, 74, 95],
     [224, 112, 17, 179, 99, 222]),
    ("rwkv6-3b-smoke", [29, 15, 228, 87, 225, 180],
     [29, 15, 228, 87, 225, 180])])
def test_reference_kv_gap_on_the_families(arch, engine, manual):
    """The reference engine's KV gap (ROADMAP.md queue 3 item 5) reaches
    zamba2's shared-attention caches, whose length the engine sets: its
    greedy tokens leave the prefill -> decode_step loop's.  rwkv6 has no
    KV cache and no gap.  Both packages give the same tokens."""
    params = tree(arch)
    prompt = np.random.default_rng(1).integers(0, 256, 8).astype(np.int32)
    [ref] = JServeEngine(j_get_config(arch), params, n_slots=1,
                         max_len=64).run([JRequest(prompt=prompt,
                                                   max_new_tokens=6)])
    [port] = ServeEngine(get_config(arch), params, n_slots=1, max_len=64,
                         device="cpu").run([Request(prompt=prompt,
                                                    max_new_tokens=6)])
    jm = j_build_model(j_get_config(arch))
    j_manual = manual_greedy(
        lambda p: jm.prefill(params, jnp.asarray(p)[None], max_len=64),
        lambda t, c: jm.decode_step(params, jnp.asarray([[t]], jnp.int32),
                                    c),
        lambda o: int(jnp.argmax(o.logits[0, -1])), prompt, 6)
    tm = load_jax_lm_params(build_model(get_config(arch), "cpu"), params)
    with torch.no_grad():
        t_manual = manual_greedy(
            lambda p: tm.prefill(torch.as_tensor(p.astype(np.int64))[None],
                                 max_len=64),
            lambda t, c: tm.decode_step(torch.tensor([[t]]), c),
            lambda o: int(torch.argmax(o.logits[0, -1])), prompt, 6)
    assert ref.generated == port.generated == engine
    assert j_manual == t_manual == manual


def test_whisper_through_the_engine_raises_in_both_packages():
    """The engine's prefill passes no audio, so Whisper's encoder meets
    None: AttributeError in both (`repro/serve/engine.py:52-53`,
    `repro/models/whisper.py:207-209`).  Whisper is served through its
    own prefill(audio_embeds=) and decode_step."""
    arch = "whisper-medium-smoke"
    prompt = np.arange(4, dtype=np.int32)
    ref = JServeEngine(j_get_config(arch), tree(arch), n_slots=2,
                       max_len=32)
    port = ServeEngine(get_config(arch), tree(arch), n_slots=2, max_len=32,
                       device="cpu")
    message = "'NoneType' object has no attribute 'shape'"
    with pytest.raises(AttributeError, match=message):
        ref.admit(JRequest(prompt=prompt))
    with pytest.raises(AttributeError, match=message):
        port.admit(Request(prompt=prompt))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_twin_main_serves_a_family_on_the_cpu(arch, capsys):
    assert lm_serve.main(["--arch", arch, "--device", "cpu", "--requests",
                          "5", "--new-tokens", "6"]) == 0
    out = capsys.readouterr().out
    assert "served 5 requests, 30 tokens" in out
    assert out.rstrip().endswith("lm_serve OK")


def test_twin_serves_rwkv6_like_the_reference_example():
    """`--arch rwkv6-3b-smoke` (the reference example's own docstring
    command) from the reference's parameters: greedy requests equal to
    the reference engine's at the example's settings."""
    arch = "rwkv6-3b-smoke"
    done, _, _ = lm_serve.run(arch, 6, 16, device="cpu", params=tree(arch))
    ref = JServeEngine(j_get_config(arch), tree(arch),
                       n_slots=lm_serve.N_SLOTS,
                       max_len=lm_serve.MAX_LEN).run(
        [JRequest(prompt=r.prompt, max_new_tokens=16,
                  temperature=r.temperature)
         for r in lm_serve.requests(get_config(arch), 6, 16)])
    assert len(done) == 6
    for p, r in zip(done, ref):
        if p.temperature == 0.0:
            assert p.generated == r.generated


def test_engine_and_twin_need_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(get_config(ARCH), tree(), n_slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_serve.main(["--requests", "1"])
    model = init_params(build_model(get_config(ARCH), "cpu"), 0)
    engine = ServeEngine(get_config(ARCH), model, n_slots=1, max_len=16)
    assert engine.device.type == "cpu"  # a model is served where it lies


def test_lazy_exports_resolve_and_import_no_torch():
    import repro_torch.serve as serve
    from repro_torch.serve import engine
    assert serve.ServeEngine is engine.ServeEngine
    assert serve.Request is engine.Request
    assert {"ServeEngine", "Request"} <= set(dir(serve))
    code = ("import sys, repro_torch.serve as s; "
            "assert 'torch' not in sys.modules, 'torch imported'; "
            "assert 'ServeEngine' in s.__all__")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60,
                   env={"PYTHONPATH": str(REPO / "src"),
                        "PATH": "/usr/bin:/bin"})

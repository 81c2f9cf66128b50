"""The port's Gradio demos (``mosstts_tpu_torch/serve/gradio_apps.py``)
against the JAX package's on the CPU, with gradio stubbed.

gradio is not installed here (nor on the card machine): a module fixture
puts a ``MagicMock`` at ``sys.modules["gradio"]``, as
``tests/test_gradio_apps.py`` does, whose ``Error`` is a real exception
class, and restores what was there after the module.

- Every builder makes the same ``gr.*`` calls as JAX's (components, labels,
  ranges, defaults, ``type=``, ``streaming=``, rows, event wiring; titles
  and headings name the port), and wires a handler of the port's factory
  with the JAX closure's arguments.
- The Delay handlers, called with UI-shaped values (floats from the
  sliders, wave file paths), against the JAX demos' click handlers taken
  from the mock, on the weights of ``tests/test_torch_pipelines.py`` (its
  ``backends`` fixture: a ``tiny_qwen3(hidden_size=128)`` backbone with
  n_vq = 4 and the tiny 24 kHz codec, bridged, each engine wrapped to decode
  greedily). Tolerance: the grids equal, the waves within 1e-4 absolute
  (float32), the statuses equal but for the elapsed time.
- The Realtime handler against the JAX demo's generator on the tiny
  Realtime weights of ``tests/test_torch_realtime.py`` and the same codec:
  each package's session draws greedily, and stops draining at ``FRAMES``
  frames in place of an EOS the random weights need not emit. The same
  yields, the chunks within 1e-4.
- The TTSD handler's half-given speaker, and the module without gradio.
"""
import importlib
import inspect
import re
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.engine import streaming as js
from mosstts_tpu.engine.realtime_engine import RealtimeEngine as JEngine
from mosstts_tpu.processing.realtime_processor import RealtimeProcessor as JProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.engine import streaming as ts
from mosstts_tpu_torch.engine.realtime_engine import RealtimeEngine
from test_torch_pipelines import backends, wavs  # noqa: F401 (module fixtures)
from test_torch_realtime import (CFG as RT_CFG, RVQ, TCFG, fast_jax_compiles,  # noqa: F401
                                 numpy_params, one_thread, port_params, proc)

TAPPS = "mosstts_tpu_torch.serve.gradio_apps"
JAPPS = "mosstts_tpu.serve.gradio_apps"
APPS = ("tts", "ttsd", "voice", "sfx", "realtime")
FACTORY = dict(tts="tts_handler", ttsd="ttsd_handler", voice="voice_handler",
               sfx="sfx_handler", realtime="realtime_handler")
HEADINGS = ("Blocks", "Markdown")  # titles and headings name each package
FRAMES = 30  # frames of a Realtime turn


class UIError(Exception):
    """Stands in for ``gradio.Error``."""


@pytest.fixture(scope="module")
def gr():
    old = sys.modules.get("gradio")
    stub = mock.MagicMock(name="gradio")
    stub.Error = UIError
    sys.modules["gradio"] = stub
    sys.modules.pop(JAPPS, None)  # JAX's module binds gradio when it is imported
    yield stub
    sys.modules.pop(JAPPS, None)
    if old is None:
        sys.modules.pop("gradio", None)
    else:
        sys.modules["gradio"] = old


@pytest.fixture(scope="module")
def apps(gr):
    return importlib.import_module(JAPPS), importlib.import_module(TAPPS)


def _norm(x):
    """A recorded argument, comparable across the two builds: a component
    by its mock's name, a handler as a placeholder."""
    if isinstance(x, mock.Mock):
        return x._extract_mock_name()
    if callable(x):
        return "<fn>"
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    return x


def _build(gr, build):
    """``build()``'s gradio calls (headings without their text) and the
    handler of its one ``click``."""
    gr.reset_mock()
    build()
    calls = [(name, None, None) if name in HEADINGS else
             (name, _norm(args), {k: _norm(v) for k, v in kwargs.items()})
             for name, args, kwargs in gr.mock_calls]
    clicks = [c for c in gr.mock_calls if c[0].endswith(".click")]
    assert len(clicks) == 1
    return calls, clicks[0]


def _loaders(monkeypatch, apps, delay, realtime):
    for mod, d, r in zip(apps, delay, realtime):
        monkeypatch.setattr(mod, "load_delay_backend", lambda *a, _d=d, **k: _d)
        monkeypatch.setattr(mod, "load_realtime_backend", lambda *a, _r=r, **k: _r)


@pytest.mark.parametrize("app", APPS)
def test_builder_makes_jax_components_and_wiring(gr, apps, app, monkeypatch):
    _loaders(monkeypatch, apps, ("jax backend", "port backend"),
             (("e", "p", "c"), ("e", "p", "c")))
    jmod, tmod = apps
    jcalls, jclick = _build(gr, jmod.BUILDERS[app])
    tcalls, tclick = _build(gr, lambda: tmod.BUILDERS[app](device="cpu"))
    assert tcalls == jcalls
    assert any(name == "Blocks" for name, _, _ in tcalls)
    (jfn, jin, jout), (tfn, tin, tout) = jclick[1], tclick[1]
    assert len(tin) == len(jin) and len(tout) == len(jout) == 2
    assert list(inspect.signature(tfn).parameters) == list(inspect.signature(jfn).parameters)
    assert tfn.__qualname__.startswith(FACTORY[app] + ".<locals>.")


def test_tts_duration_updater_equals_jax(gr, apps, monkeypatch):
    _loaders(monkeypatch, apps, (None, None), (None, None))
    updates = []
    for build in (apps[0].build_tts_demo, lambda: apps[1].build_tts_demo(device="cpu")):
        gr.reset_mock()
        build()
        (fn, src, dst), = [c.args for c in gr.Textbox.return_value.change.call_args_list]
        for text in ("", "hello there, this is a test", "你好，世界"):
            fn(text)
        updates.append(gr.update.call_args_list)
    assert len(updates[1]) == 3 and updates[1] == updates[0]


def _jax_handler(gr, apps, monkeypatch, app, delay=None, realtime=None):
    """The JAX demo's click handler, as ``tests/test_gradio_apps.py`` takes it."""
    _loaders(monkeypatch, apps, (delay, None), (realtime, None))
    _, click = _build(gr, apps[0].BUILDERS[app])
    return click.args[0]


# UI-shaped values: sliders give floats, audio components file paths or None
DELAY_CASES = {
    "tts_direct_duration": ("tts", lambda w: (
        "hello from the stubbed ui", "Direct", None, True, 8.0, 1.7, 0.8, 25.0, 1.0, 48.0)),
    "tts_clone": ("tts", lambda w: (
        "clone this voice", "Clone", w[0], False, 100.0, 1.7, 0.8, 25.0, 1.0, 40.0)),
    "tts_continuation": ("tts", lambda w: (
        "and go on from here", "Continuation", w[1], False, 100.0, 1.7, 0.8, 25.0, 1.0, 40.0)),
    "ttsd_two_speakers": ("ttsd", lambda w: (
        "[S1]Hello  there...  how are you?? [S2]Fine -- thanks!!", 2.0, True, False,
        1.1, 0.9, 50.0, 1.1, 40.0, w[0], w[1], None, None, None,
        "[S1]This is the first voice.", "[S2]And this is the second.", "", "", "")),
    "voice": ("voice", lambda w: ("hello", "a deep calm voice", 1.5, 0.6, 50.0, 1.1, 40.0)),
    "sfx": ("sfx", lambda w: ("rain on a tin roof", 1.0, 1.5, 0.6, 50.0, 1.2)),
}


def _generate_kwargs(monkeypatch, backend):
    """The keywords of each ``backend.engine.generate`` call from now on
    (the sampling the sliders set, before the greedy wrapper overrides
    the temperatures)."""
    seen, generate = [], backend.engine.generate

    def recorded(*args, **kw):
        seen.append(dict(kw))
        return generate(*args, **kw)

    monkeypatch.setattr(backend.engine, "generate", recorded)
    return seen


@pytest.mark.parametrize("case", list(DELAY_CASES))
def test_delay_handler_matches_jax(gr, apps, backends, wavs, case, monkeypatch):
    jb, tb = backends
    app, values = DELAY_CASES[case]
    jrun = _jax_handler(gr, apps, monkeypatch, app, delay=jb)
    trun = getattr(apps[1], FACTORY[app])(tb)
    jkw, tkw = _generate_kwargs(monkeypatch, jb), _generate_kwargs(monkeypatch, tb)
    (jsr, jwav), jstatus = jrun(*values(wavs))
    (tsr, twav), tstatus = trun(*values(wavs))
    assert len(tkw) == len(jkw) == 1 and tkw == jkw
    assert tsr == jsr == 24000
    assert tstatus.startswith("Done")
    assert re.sub(r"elapsed=\S+", "", tstatus) == re.sub(r"elapsed=\S+", "", jstatus)
    jcall, tcall = jb.engine.calls[-1], tb.engine.calls[-1]
    assert len(tcall) == len(jcall) == 1 and tcall[0][0] == jcall[0][0]
    np.testing.assert_array_equal(tcall[0][1], jcall[0][1])
    assert twav.dtype == np.float32 and twav.ndim == 1 and twav.size > 0
    assert twav.shape == jwav.shape and np.isfinite(twav).all()
    np.testing.assert_allclose(twav, jwav, rtol=0, atol=1e-4)


def test_ttsd_half_given_speaker_raises_as_jax(gr, apps, backends, wavs, monkeypatch):
    jb, tb = backends
    values = ("[S1]Hi. [S2]Hello.", 2.0, True, False, 1.1, 0.9, 50.0, 1.1, 40.0,
              wavs[0], None, None, None, None, "", "[S2]only a prompt", "", "", "")
    jrun = _jax_handler(gr, apps, monkeypatch, "ttsd", delay=jb)
    with pytest.raises(UIError) as want:
        jrun(*values)
    trun = apps[1].ttsd_handler(tb)
    with pytest.raises(UIError) as got:
        trun(*values)
    assert str(got.value) == str(want.value) == "S1 needs both reference audio and prompt text."
    monkeypatch.setitem(sys.modules, "gradio", None)  # no gradio: a ValueError, same text
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        trun(*values)


def _session(module):
    """``module``'s session, drawing greedily and draining ``FRAMES``
    frames at most."""

    class Session(module.RealtimeStreamingSession):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.do_sample = False

        def drain(self, max_steps=None):
            if len(self.inferencer.generated_tokens) >= FRAMES:
                return []
            return super().drain(max_steps)

    return Session


@pytest.mark.parametrize("voice", [False, True], ids=["no_voice", "voice_prompt"])
def test_realtime_handler_matches_jax(gr, apps, backends, wavs, proc, voice, monkeypatch):
    jb, tb = backends
    jp = numpy_params()
    kw = dict(max_length=24, cache_len=512, prefill_bucket=512)
    jrt = (JEngine(jp, RT_CFG, dtype=jnp.float32, **kw),
           JProcessor(ByteFallbackTokenizer(), channels=RVQ), jb.processor.audio_tokenizer)
    trt = (RealtimeEngine(port_params(jp), TCFG, dtype=torch.float32, device="cpu", **kw),
           proc, tb.processor.audio_tokenizer)
    monkeypatch.setattr(js, "RealtimeStreamingSession", _session(js))
    monkeypatch.setattr(apps[1], "RealtimeStreamingSession", _session(ts))
    jrun = _jax_handler(gr, apps, monkeypatch, "realtime", realtime=jrt)
    trun = apps[1].realtime_handler(*trt, ts.AudioTokenCache(max_entries=32))
    values = ("the port streams this reply, one chunk at a time.",
              wavs[1] if voice else None, 0.8, 0.6, 30.0, 1.1, 12.0, 0.0, 0.0)
    want, got = list(jrun(*values)), list(trun(*values))
    assert len(got) == len(want) > 2
    for (g, gs), (w, ws) in zip(got[:-1], want[:-1]):
        assert g[0] == w[0] == 24000 and gs.startswith("chunk ")
        assert g[1].shape == w[1].shape and g[1].size > 0
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-4)
    assert got[-1][0] is None and want[-1][0] is None
    assert got[-1][1].startswith("done | {") and want[-1][1].startswith("done | {")
    assert len(trt[0].generated_tokens) == len(jrt[0].generated_tokens) >= FRAMES


def test_module_imports_without_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    monkeypatch.delitem(sys.modules, TAPPS, raising=False)
    mod = importlib.import_module(TAPPS)
    assert set(mod.BUILDERS) == set(APPS) and mod.MAX_SPEAKERS == 5
    with pytest.raises(ImportError, match=r"mosstts_tpu_torch\.serve\.cli"):
        mod.build_tts_demo(device="cpu")


def test_builders_default_to_the_card(apps):
    for build in apps[1].BUILDERS.values():
        assert inspect.signature(build).parameters["device"].default == "cuda"

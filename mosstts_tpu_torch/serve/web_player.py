"""Browser streaming player for the realtime HTTP path.

Serving-UX parity with the reference realtime gradio app's Web Audio player
(reference moss_tts_realtime/app.py:559-805): the reference smuggles
base64-JSON PCM chunks through a hidden textbox into a JS AudioContext with
edge fades; ours streams chunked PCM16 straight from ``POST /stream`` via
``fetch`` + ReadableStream into scheduled AudioBuffers with the same short
edge fades, and reports TTFB (first audible chunk) plus live RTF polled
from ``GET /metrics`` (the chunked-encoding ttfa/rtf extensions are
invisible to browser fetch by spec, so metrics ride the side channel).

Dependency-free: one self-contained HTML page served by http_server's
``GET /player``.

The port's own copy of ``mosstts_tpu/serve/web_player.py``. The page's
``fetch('/stream')`` reaches the port's ``POST /stream`` route
(``serve/http_server.py``), which streams the Realtime family's audio.
"""

PLAYER_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>mosstts-tpu streaming player</title>
<style>
  body { font-family: system-ui, sans-serif; max-width: 720px; margin: 2rem auto; }
  textarea { width: 100%; height: 6rem; }
  .row { margin: .6rem 0; display: flex; gap: .8rem; align-items: center; }
  .metrics { font-variant-numeric: tabular-nums; color: #333; }
  button { padding: .4rem 1.2rem; }
  label { font-size: .9rem; }
  input[type=number] { width: 5rem; }
</style>
</head>
<body>
<h2>mosstts-tpu &mdash; realtime streaming</h2>
<textarea id="text">Hello there! This audio is being synthesized and played
back incrementally while the model is still generating.</textarea>
<div class="row">
  <label>prebuffer (s) <input id="prebuf" type="number" value="0.3" step="0.1"></label>
  <label>chunk frames <input id="chunkf" type="number" value="12" step="1"></label>
  <label>temperature <input id="temp" type="number" value="0.8" step="0.1"></label>
  <button id="go">Speak</button>
  <button id="stop" disabled>Stop</button>
</div>
<div class="row metrics" id="metrics">idle</div>
<script>
const FADE_S = 0.005;            // edge fade, like the reference player
let ctx = null, nextTime = 0, abort = null;

function pcm16ToFloat(bytes) {
  const n = bytes.byteLength >> 1;
  const view = new DataView(bytes.buffer, bytes.byteOffset, n * 2);
  const out = new Float32Array(n);
  for (let i = 0; i < n; i++) out[i] = view.getInt16(2 * i, true) / 32768;
  return out;
}

function fadeEdges(f32, sr) {
  const n = Math.min(Math.floor(FADE_S * sr), f32.length >> 1);
  for (let i = 0; i < n; i++) {
    const g = i / n;
    f32[i] *= g;
    f32[f32.length - 1 - i] *= g;
  }
}

function schedule(f32, sr) {
  const buf = ctx.createBuffer(1, f32.length, sr);
  buf.copyToChannel(f32, 0);
  const src = ctx.createBufferSource();
  src.buffer = buf;
  src.connect(ctx.destination);
  const t = Math.max(nextTime, ctx.currentTime + 0.02);
  src.start(t);
  nextTime = t + buf.duration;
}

async function pollMetrics(el) {
  try {
    const m = await (await fetch('/metrics')).json();
    if (m && m.rtf) el.dataset.rtf = Number(m.rtf).toFixed(2);
  } catch (e) { /* server busy mid-stream */ }
}

document.getElementById('go').onclick = async () => {
  const el = document.getElementById('metrics');
  const goBtn = document.getElementById('go');
  const stopBtn = document.getElementById('stop');
  goBtn.disabled = true; stopBtn.disabled = false;
  abort = new AbortController();
  el.textContent = 'requesting...';
  const t0 = performance.now();
  let ttfb = null, samples = 0, sr = 24000;
  const poll = setInterval(() => pollMetrics(el), 1000);
  try {
    const resp = await fetch('/stream', {
      method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({
        text: document.getElementById('text').value,
        prebuffer_seconds: Number(document.getElementById('prebuf').value),
        chunk_frames: Number(document.getElementById('chunkf').value),
        temperature: Number(document.getElementById('temp').value),
      }),
      signal: abort.signal,
    });
    sr = Number(resp.headers.get('X-Sample-Rate') || 24000);
    ctx = new (window.AudioContext || window.webkitAudioContext)({sampleRate: sr});
    nextTime = ctx.currentTime;
    const reader = resp.body.getReader();
    let carry = new Uint8Array(0);
    for (;;) {
      const {done, value} = await reader.read();
      if (done) break;
      if (ttfb === null) ttfb = performance.now() - t0;
      // keep 16-bit alignment across network chunk boundaries
      const merged = new Uint8Array(carry.length + value.length);
      merged.set(carry); merged.set(value, carry.length);
      const usable = merged.length & ~1;
      carry = merged.slice(usable);
      if (!usable) continue;
      const f32 = pcm16ToFloat(merged.slice(0, usable));
      fadeEdges(f32, sr);
      schedule(f32, sr);
      samples += f32.length;
      const rtf = el.dataset.rtf || '-';
      el.textContent = `TTFB ${ttfb.toFixed(0)} ms | ${(samples / sr).toFixed(1)} s audio | RTF ${rtf}`;
    }
    el.textContent += ' | done';
  } catch (e) {
    el.textContent = (e.name === 'AbortError') ? 'stopped' : ('error: ' + e);
  } finally {
    clearInterval(poll);
    goBtn.disabled = false; stopBtn.disabled = true;
  }
};

document.getElementById('stop').onclick = () => { if (abort) abort.abort(); };
</script>
</body>
</html>
"""

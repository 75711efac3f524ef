"""Built-in browser demo (replaces the reference's gradio demos, which need
the gradio package — absent in this image). A single self-contained HTML
page served by the HTTP server:

- Dialogue tab: multi-speaker text, audio streams in over the WebSocket and
  plays via WebAudio (reference enhanced_gradio_demo.py streaming panel);
- Voice cloning tab: upload prompt audio + reference text -> voice profile
  (persisted by serve/voices.py through /api/v1/voices), then monologue
  synthesis in that voice via /api/v1/tts/clone (reference
  gradio_demo.py:153-198, enhanced_gradio_demo.py:245-340);
- Metrics tab: live /stats poll — first-packet/RTF percentiles, stream
  counts, block-policy estimate, recommendation-engine output (reference
  enhanced_gradio_demo.py performance metrics panel, :560-620);
- zh/en language toggle (reference gradio_demo.py i18n table, :29-120).
"""

DEMO_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>fireredtts2_tpu_torch demo</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:760px;margin:2rem auto;padding:0 1rem;background:#111;color:#eee}
 textarea,input[type=text]{width:100%;background:#1c1c1c;color:#eee;border:1px solid #444;border-radius:6px;padding:.5rem;box-sizing:border-box}
 textarea{height:7rem}
 button{padding:.6rem 1.4rem;border-radius:6px;border:0;background:#c33;color:#fff;font-size:1rem;cursor:pointer}
 button:disabled{background:#555}
 select{background:#1c1c1c;color:#eee;border:1px solid #444;border-radius:4px;padding:.4rem}
 .row{display:flex;gap:1rem;margin:.8rem 0;align-items:center;flex-wrap:wrap}
 label{font-size:.9rem;color:#aaa}
 input[type=number]{width:5rem;background:#1c1c1c;color:#eee;border:1px solid #444;border-radius:4px;padding:.3rem}
 #log,#clog{font-family:monospace;font-size:.8rem;color:#8c8;white-space:pre-wrap}
 .tab{display:inline-block;padding:.5rem 1rem;cursor:pointer;border-bottom:2px solid transparent;color:#aaa}
 .tab.active{color:#eee;border-color:#c33}
 .panel{display:none}.panel.active{display:block}
</style></head><body>
<h2>fireredtts2_tpu_torch <select id="lang" style="float:right"><option value="en">English</option><option value="zh">中文</option></select></h2>
<div>
 <span class="tab active" data-p="dlg" data-i18n="tab_dlg">Dialogue</span>
 <span class="tab" data-p="clone" data-i18n="tab_clone">Voice cloning</span>
 <span class="tab" data-p="metrics" data-i18n="tab_metrics">Metrics</span>
</div>

<div id="dlg" class="panel active">
<p data-i18n="dlg_help">Multi-speaker text with <code>[S1]..[S4]</code> tags. Audio streams as it
is generated (first packet in well under a second).</p>
<textarea id="text">[S1]Hello there, welcome to the show. [S2]Thanks, great to be here!</textarea>
<div class="row">
 <label>temperature <input id="temp" type="number" value="0.9" step="0.05"></label>
 <label>top-k <input id="topk" type="number" value="20" step="1"></label>
 <button id="go" data-i18n="btn_generate">Generate</button>
</div>
<div id="log"></div>
</div>

<div id="metrics" class="panel">
<h3 data-i18n="m_title">Live serving metrics</h3>
<table style="width:100%;font-size:.9rem" id="mtable"></table>
<h3 data-i18n="m_recs">Recommendations</h3>
<div id="mrecs" style="font-size:.9rem;color:#fc6"></div>
<pre id="mraw" style="font-size:.7rem;color:#777;max-height:14rem;overflow:auto"></pre>
</div>

<div id="clone" class="panel">
<h3 data-i18n="c_step1">1. Create a voice profile</h3>
<div class="row"><input id="vname" type="text" placeholder="voice name"></div>
<div class="row"><input id="vtext" type="text" placeholder="reference text (what the prompt audio says)"></div>
<div class="row"><input id="vfile" type="file" accept="audio/*">
 <button id="vcreate">Create profile</button></div>
<h3 data-i18n="c_step2">2. Speak in that voice</h3>
<div class="row"><select id="vsel"></select>
 <button id="vrefresh" title="reload profiles">&#8635;</button></div>
<textarea id="ctext">Hello! This is my cloned voice speaking on a tensor processing unit.</textarea>
<div class="row"><button id="cgo">Clone &amp; speak</button></div>
<div id="clog"></div>
</div>

<script>
const $ = id => document.getElementById(id);
const log = m => $('log').textContent += m + "\\n";
const clog = m => $('clog').textContent += m + "\\n";
// ------------------------------------------------ i18n (zh/en — the
// reference gradio demo ships a zh/en string table, gradio_demo.py:29-120)
const I18N = {
  en: {tab_dlg: 'Dialogue', tab_clone: 'Voice cloning', tab_metrics: 'Metrics',
       dlg_help: 'Multi-speaker text with [S1]..[S4] tags. Audio streams as it is generated.',
       btn_generate: 'Generate', m_title: 'Live serving metrics',
       m_recs: 'Recommendations', c_step1: '1. Create a voice profile',
       c_step2: '2. Speak in that voice'},
  zh: {tab_dlg: '\\u5bf9\\u8bdd\\u5408\\u6210', tab_clone: '\\u58f0\\u97f3\\u514b\\u9686', tab_metrics: '\\u6027\\u80fd\\u76d1\\u63a7',
       dlg_help: '\\u591a\\u8bf4\\u8bdd\\u4eba\\u6587\\u672c\\uff0c\\u4f7f\\u7528 [S1]..[S4] \\u6807\\u7b7e\\u3002\\u97f3\\u9891\\u8fb9\\u751f\\u6210\\u8fb9\\u64ad\\u653e\\u3002',
       btn_generate: '\\u751f\\u6210', m_title: '\\u5b9e\\u65f6\\u670d\\u52a1\\u6307\\u6807',
       m_recs: '\\u4f18\\u5316\\u5efa\\u8bae', c_step1: '1. \\u521b\\u5efa\\u58f0\\u97f3\\u6863\\u6848',
       c_step2: '2. \\u7528\\u8be5\\u58f0\\u97f3\\u8bf4\\u8bdd'},
};
$('lang').onchange = () => {
  const t = I18N[$('lang').value];
  document.querySelectorAll('[data-i18n]').forEach(el => {
    if (t[el.dataset.i18n]) el.textContent = t[el.dataset.i18n];
  });
};
document.querySelectorAll('.tab').forEach(t => t.onclick = () => {
  document.querySelectorAll('.tab').forEach(x => x.classList.remove('active'));
  document.querySelectorAll('.panel').forEach(x => x.classList.remove('active'));
  t.classList.add('active'); $(t.dataset.p).classList.add('active');
});
// ------------------------------------------------ metrics panel
async function pollStats() {
  if (!$('metrics').classList.contains('active')) return;
  try {
    const d = await (await fetch('/stats')).json();
    const rows = [
      ['first packet p50 / p95 (ms)',
       `${(d.first_packet_ms_p50||0).toFixed(0)} / ${(d.first_packet_ms_p95||0).toFixed(0)}`],
      ['RTF p50', (d.rtf_p50||0).toFixed(2)],
      ['active / queued streams', `${d.active_streams??d.active??0} / ${d.queue_depth??0}`],
      ['completed / errors', `${d.completed??0} / ${d.errors??0}`],
      ['chunk drops', d.chunk_drops??0],
      ['block policy (rtt / frame ms)',
       d.block_policy ? `${d.block_policy.rtt_ms??'-'} / ${d.block_policy.frame_cost_ms??'-'}` : '-'],
      ['device bytes in use', ((d.device||{}).bytes_in_use||0).toLocaleString()],
    ];
    $('mtable').innerHTML = rows.map(r =>
      `<tr><td style="color:#aaa">${r[0]}</td><td>${r[1]}</td></tr>`).join('');
    const recs = d.recommendations || [];
    $('mrecs').textContent = recs.length
      ? recs.map(r => `[${r.severity}] ${r.message} — ${r.action}`).join('\\n')
      : 'all healthy';
    $('mraw').textContent = JSON.stringify(d, null, 1);
  } catch (e) { $('mrecs').textContent = 'stats unavailable: ' + e; }
}
setInterval(pollStats, 2000);
let actx;
function playPcm16(hex, rate, at) {
  const n = hex.length / 4;
  const buf = actx.createBuffer(1, n, rate);
  const ch = buf.getChannelData(0);
  for (let i = 0; i < n; i++) {
    let v = parseInt(hex.substr(i*4, 2), 16) | (parseInt(hex.substr(i*4+2, 2), 16) << 8);
    if (v >= 32768) v -= 65536;
    ch[i] = v / 32768;
  }
  const src = actx.createBufferSource();
  src.buffer = buf; src.connect(actx.destination);
  const t = Math.max(at, actx.currentTime + 0.05);
  src.start(t);
  return t + buf.duration;
}
// ------------------------------------------------ dialogue streaming
$('go').onclick = () => {
  actx = actx || new AudioContext();
  const btn = $('go');
  btn.disabled = true;
  $('log').textContent = '';
  const ws = new WebSocket(`ws://${location.hostname}:__WS_PORT__`);
  let playAt = 0, t0 = performance.now(), first = true, lastUtt = -1;
  ws.onopen = () => {
    // Multiple [S1]/[S2] tags -> the KV-persistent streaming-dialogue
    // message (one socket round trip per whole dialogue); otherwise a
    // plain single-utterance stream.
    const txt = $('text').value;
    const parts = txt.split(/(?=\\[S[1-4]\\])/).map(s => s.trim()).filter(Boolean);
    const multi = parts.length > 1 && parts.every(p => /^\\[S[1-4]\\]/.test(p));
    ws.send(JSON.stringify(multi
      ? {type: 'generate_dialogue', text_list: parts,
         temperature: parseFloat($('temp').value),
         top_k: parseInt($('topk').value)}
      : {type: 'generate_speech', text: txt,
         temperature: parseFloat($('temp').value),
         top_k: parseInt($('topk').value), streaming: true}));
    log(multi ? `dialogue request sent (${parts.length} utterances)`
              : 'request sent');
  };
  ws.onmessage = ev => {
    const m = JSON.parse(ev.data);
    if (m.type === 'audio_chunk') {
      if (first) { log(`first packet: ${(performance.now()-t0).toFixed(0)} ms`); first = false; }
      if (m.utterance !== undefined && m.utterance !== lastUtt) {
        lastUtt = m.utterance; log(`utterance ${m.utterance + 1} ...`);
      }
      playAt = playPcm16(m.data, m.sample_rate, playAt);
    } else if (m.type === 'generation_complete') {
      log(`done: ${m.duration_s.toFixed(2)}s in ${m.chunks} chunks`);
      ws.close(); btn.disabled = false;
    } else if (m.type === 'error') {
      log('error: ' + m.error); ws.close(); btn.disabled = false;
    }
  };
  ws.onerror = () => { log('websocket error'); btn.disabled = false; };
};
// ------------------------------------------------ voice cloning
async function fileToPcm16Hex(file) {
  // decode any browser-supported audio, resample to 16 kHz mono PCM16 hex
  const raw = await file.arrayBuffer();
  const dctx = new AudioContext();
  const buf = await dctx.decodeAudioData(raw);
  const octx = new OfflineAudioContext(1, Math.ceil(buf.duration * 16000), 16000);
  const src = octx.createBufferSource();
  src.buffer = buf; src.connect(octx.destination); src.start();
  const out = (await octx.startRendering()).getChannelData(0);
  let hex = new Array(out.length);
  for (let i = 0; i < out.length; i++) {
    let v = Math.max(-1, Math.min(1, out[i])) * 32767 | 0;
    if (v < 0) v += 65536;
    hex[i] = (v & 255).toString(16).padStart(2,'0') + (v >> 8).toString(16).padStart(2,'0');
  }
  return hex.join('');
}
async function refreshVoices() {
  const r = await fetch('/api/v1/voices');
  const d = await r.json();
  const sel = $('vsel');
  sel.innerHTML = '';
  for (const v of d.voices) {
    const o = document.createElement('option');
    o.value = v.profile_id; o.textContent = v.name;
    sel.appendChild(o);
  }
}
$('vrefresh').onclick = refreshVoices;
refreshVoices().catch(() => clog('voices API disabled (start serve with --voice-dir)'));
$('vcreate').onclick = async () => {
  const f = $('vfile').files[0];
  if (!f || !$('vname').value || !$('vtext').value) { clog('need name, reference text, and an audio file'); return; }
  $('vcreate').disabled = true;
  try {
    clog('encoding audio...');
    const hexData = await fileToPcm16Hex(f);
    const r = await fetch('/api/v1/voices/create', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({name: $('vname').value, reference_text: $('vtext').value,
                            data: hexData, sample_rate: 16000})});
    const d = await r.json();
    if (!r.ok) { clog('error: ' + d.error); return; }
    clog(`profile "${d.name}" created (snr ${d.quality.snr_db?.toFixed?.(1)} dB)`);
    await refreshVoices();
  } finally { $('vcreate').disabled = false; }
};
$('cgo').onclick = async () => {
  actx = actx || new AudioContext();
  const pid = $('vsel').value;
  if (!pid) { clog('create/select a voice profile first'); return; }
  $('cgo').disabled = true;
  clog('generating...');
  try {
    const r = await fetch('/api/v1/tts/clone', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({text: $('ctext').value, voice_profile_id: pid})});
    const d = await r.json();
    if (!r.ok) { clog('error: ' + d.error); return; }
    clog(`done: ${d.duration_s.toFixed(2)}s in voice "${d.voice}"`);
    playPcm16(d.data, d.sample_rate, 0);
  } finally { $('cgo').disabled = false; }
};
</script></body></html>
"""


def demo_page(ws_port: int) -> str:
    return DEMO_HTML.replace("__WS_PORT__", str(ws_port))

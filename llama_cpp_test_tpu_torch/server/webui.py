"""Built-in browser chat UI (the reference's examples/server/webui/
analogue, served by server.cpp at GET /). Copy of
llama_cpp_test_tpu/server/webui.py.

One self-contained HTML document — no external assets, no build step —
served at GET / and /index.html. Talks to this server's own
/v1/chat/completions (SSE streaming), /props and /health endpoints.
Conversations and settings persist in the browser's localStorage; an
API-key field covers servers launched with --api-key.
"""

INDEX_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>llama_cpp_test_tpu server</title>
<style>
:root{
  --bg:#10141a; --panel:#171c24; --panel2:#1e242e; --border:#2a323e;
  --fg:#d7dde6; --dim:#8b95a3; --accent:#4f9cf7; --user:#243142;
  --err:#e06c75; --ok:#71c280;
}
*{box-sizing:border-box}
body{margin:0;background:var(--bg);color:var(--fg);
  font:15px/1.55 system-ui,-apple-system,"Segoe UI",sans-serif;
  display:flex;height:100vh}
#side{width:300px;min-width:240px;background:var(--panel);
  border-right:1px solid var(--border);display:flex;flex-direction:column;
  padding:12px;gap:10px;overflow-y:auto}
#side h1{font-size:15px;margin:2px 0 0;display:flex;align-items:center;gap:8px}
#side h1 .dot{width:9px;height:9px;border-radius:50%;background:var(--err);
  display:inline-block}
#side h1 .dot.up{background:var(--ok)}
#model{font-size:12px;color:var(--dim);word-break:break-all}
label{font-size:12px;color:var(--dim);display:block;margin-bottom:2px}
input[type=text],input[type=password],input[type=number],textarea,select{
  width:100%;background:var(--panel2);color:var(--fg);
  border:1px solid var(--border);border-radius:6px;padding:6px 8px;
  font:inherit;font-size:13px}
textarea{resize:vertical}
.row2{display:grid;grid-template-columns:1fr 1fr;gap:8px}
button{background:var(--panel2);color:var(--fg);border:1px solid var(--border);
  border-radius:6px;padding:6px 10px;font:inherit;font-size:13px;
  cursor:pointer}
button:hover{border-color:var(--accent)}
button.primary{background:var(--accent);border-color:var(--accent);color:#fff}
button:disabled{opacity:.45;cursor:default}
#main{flex:1;display:flex;flex-direction:column;min-width:0}
#chat{flex:1;overflow-y:auto;padding:22px 0}
.msg{max-width:820px;margin:0 auto 14px;padding:0 20px;display:flex;gap:10px}
.msg .who{flex:none;width:30px;height:30px;border-radius:6px;
  display:flex;align-items:center;justify-content:center;font-size:12px;
  font-weight:700;background:var(--panel2);color:var(--dim)}
.msg.user .who{background:var(--accent);color:#fff}
.msg .body{min-width:0;flex:1;padding:4px 0;overflow-wrap:break-word}
.msg.user .body{background:var(--user);border-radius:8px;padding:8px 12px}
.body pre{background:#0b0e13;border:1px solid var(--border);border-radius:8px;
  padding:10px;overflow-x:auto;font-size:13px}
.body code{background:#0b0e13;border-radius:4px;padding:1px 5px;
  font-size:13px}
.body pre code{background:none;padding:0}
.body h1,.body h2,.body h3{font-size:1.05em;margin:.6em 0 .3em}
.body ul,.body ol{margin:.3em 0;padding-left:1.4em}
.body p{margin:.4em 0}
#stats{font-size:12px;color:var(--dim);text-align:center;min-height:18px}
#inbar{padding:12px 20px 18px;border-top:1px solid var(--border)}
#inwrap{max-width:820px;margin:0 auto;display:flex;gap:8px;
  align-items:flex-end}
#prompt{flex:1;min-height:44px;max-height:200px}
#err{color:var(--err);font-size:13px;max-width:820px;margin:4px auto 0;
  padding:0 20px}
.cursor::after{content:"▌";color:var(--accent);animation:blink 1s infinite}
@keyframes blink{50%{opacity:0}}
</style>
</head>
<body>
<div id="side">
  <h1><span class="dot" id="dot"></span>llama_cpp_test_tpu</h1>
  <div id="model">connecting…</div>
  <button class="primary" id="newchat">New chat</button>
  <div>
    <label>System prompt</label>
    <textarea id="sys" rows="3" placeholder="You are a helpful assistant."></textarea>
  </div>
  <div class="row2">
    <div><label>Temperature</label><input type="number" id="temp" step="0.05" value="0.8"></div>
    <div><label>Max tokens</label><input type="number" id="maxtok" value="512"></div>
    <div><label>top_k</label><input type="number" id="topk" value="40"></div>
    <div><label>top_p</label><input type="number" id="topp" step="0.05" value="0.95"></div>
    <div><label>min_p</label><input type="number" id="minp" step="0.01" value="0.05"></div>
    <div><label>repeat_penalty</label><input type="number" id="reppen" step="0.05" value="1.0"></div>
  </div>
  <div>
    <label>API key (if the server requires one)</label>
    <input type="password" id="apikey" placeholder="none">
  </div>
  <div class="row2">
    <button id="clearall">Clear history</button>
    <button id="dl">Export JSON</button>
  </div>
</div>
<div id="main">
  <div id="chat"></div>
  <div id="err"></div>
  <div id="stats"></div>
  <div id="inbar"><div id="inwrap">
    <textarea id="prompt" placeholder="Send a message…  (Enter to send, Shift+Enter for newline)"></textarea>
    <button class="primary" id="send">Send</button>
    <button id="stop" disabled>Stop</button>
  </div></div>
</div>
<script>
"use strict";
const $ = id => document.getElementById(id);
const LS = "llama_tpu_webui";
let msgs = [];          // [{role, content}]
let busy = false, aborter = null;

function loadState(){
  try{
    const s = JSON.parse(localStorage.getItem(LS) || "{}");
    msgs = s.msgs || [];
    for(const k of ["sys","temp","maxtok","topk","topp","minp","reppen","apikey"])
      if(s[k] !== undefined) $(k).value = s[k];
  }catch(e){ msgs = []; }
}
function saveState(){
  const s = {msgs};
  for(const k of ["sys","temp","maxtok","topk","topp","minp","reppen","apikey"])
    s[k] = $(k).value;
  localStorage.setItem(LS, JSON.stringify(s));
}

// minimal markdown: fences, inline code, bold/italic, headings, lists
function esc(t){return t.replace(/&/g,"&amp;").replace(/</g,"&lt;").replace(/>/g,"&gt;")}
function mdInline(t){
  return t.replace(/`([^`]+)`/g,(m,c)=>"<code>"+c+"</code>")
          .replace(/\*\*([^*]+)\*\*/g,"<b>$1</b>")
          .replace(/(^|\W)\*([^*\n]+)\*(?=\W|$)/g,"$1<i>$2</i>");
}
function mdRender(src){
  const out = [];
  const parts = src.split(/```/);
  for(let i = 0; i < parts.length; i++){
    if(i % 2 === 1){  // code fence body (first line may be a language tag)
      out.push("<pre><code>"+esc(parts[i].replace(/^[\w+-]*\n/,""))+"</code></pre>");
      continue;
    }
    const lines = esc(parts[i]).split("\n");
    let list = null, para = [];
    const flush = ()=>{ if(para.length){out.push("<p>"+mdInline(para.join(" "))+"</p>");para=[];} };
    const endList = ()=>{ if(list){out.push("</"+list+">");list=null;} };
    for(const ln of lines){
      const h = ln.match(/^(#{1,3})\s+(.*)/);
      const ul = ln.match(/^\s*[-*]\s+(.*)/);
      const ol = ln.match(/^\s*\d+[.)]\s+(.*)/);
      if(h){flush();endList();out.push("<h"+h[1].length+">"+mdInline(h[2])+"</h"+h[1].length+">");}
      else if(ul){flush();if(list!=="ul"){endList();out.push("<ul>");list="ul";}out.push("<li>"+mdInline(ul[1])+"</li>");}
      else if(ol){flush();if(list!=="ol"){endList();out.push("<ol>");list="ol";}out.push("<li>"+mdInline(ol[1])+"</li>");}
      else if(!ln.trim()){flush();endList();}
      else para.push(ln);
    }
    flush(); endList();
  }
  return out.join("");
}

function render(streamTail){
  const chat = $("chat");
  chat.innerHTML = "";
  msgs.forEach((m, i) => {
    const d = document.createElement("div");
    d.className = "msg " + m.role;
    const who = m.role === "user" ? "You" : "AI";
    const live = streamTail && i === msgs.length-1 && m.role === "assistant";
    d.innerHTML = '<div class="who">'+who+'</div><div class="body'+
      (live?' cursor':'')+'">'+mdRender(m.content)+"</div>";
    chat.appendChild(d);
  });
  chat.scrollTop = chat.scrollHeight;
}

function headers(){
  const h = {"Content-Type":"application/json"};
  const k = $("apikey").value.trim();
  if(k) h["Authorization"] = "Bearer " + k;
  return h;
}

async function refreshProps(){
  try{
    const r = await fetch("/props", {headers: headers()});
    if(r.ok){
      const p = await r.json();
      $("model").textContent = (p.model_alias || p.model_path || "model") +
        " · ctx " + (p.default_generation_settings?.n_ctx ?? p.n_ctx ?? "?");
      $("dot").className = "dot up";
      return;
    }
  }catch(e){}
  $("model").textContent = "server unreachable (or API key required)";
  $("dot").className = "dot";
}

async function send(){
  if(busy) return;
  const text = $("prompt").value.trim();
  if(!text) return;
  $("prompt").value = "";
  $("err").textContent = "";
  msgs.push({role:"user", content:text});
  msgs.push({role:"assistant", content:""});
  render(true); saveState();
  busy = true; $("send").disabled = true; $("stop").disabled = false;
  aborter = new AbortController();
  const chain = [];
  const sys = $("sys").value.trim();
  if(sys) chain.push({role:"system", content:sys});
  for(const m of msgs.slice(0,-1)) chain.push({role:m.role, content:m.content});
  const t0 = performance.now();
  let ntok = 0;
  try{
    const r = await fetch("/v1/chat/completions", {
      method:"POST", headers: headers(), signal: aborter.signal,
      body: JSON.stringify({
        messages: chain, stream: true,
        temperature: +$("temp").value, max_tokens: +$("maxtok").value,
        top_k: +$("topk").value, top_p: +$("topp").value,
        min_p: +$("minp").value, repeat_penalty: +$("reppen").value,
      })});
    if(!r.ok){
      const body = await r.text();
      throw new Error("HTTP "+r.status+": "+body.slice(0,300));
    }
    const reader = r.body.getReader();
    const dec = new TextDecoder();
    let buf = "";
    for(;;){
      const {done, value} = await reader.read();
      if(done) break;
      buf += dec.decode(value, {stream:true});
      const lines = buf.split("\n");
      buf = lines.pop();
      for(const line of lines){
        if(!line.startsWith("data: ")) continue;
        const payload = line.slice(6).trim();
        if(payload === "[DONE]") continue;
        let j; try{ j = JSON.parse(payload); }catch(e){ continue; }
        const delta = j.choices?.[0]?.delta?.content;
        if(delta){
          msgs[msgs.length-1].content += delta;
          ntok++;
          render(true);
        }
      }
    }
  }catch(e){
    if(e.name !== "AbortError") $("err").textContent = String(e);
  }
  busy = false; $("send").disabled = false; $("stop").disabled = true;
  aborter = null;
  if(!msgs[msgs.length-1].content) msgs.pop();   // failed/empty reply
  render(false); saveState();
  const dt = (performance.now()-t0)/1000;
  if(ntok) $("stats").textContent =
    ntok+" chunks · "+dt.toFixed(1)+"s · "+(ntok/dt).toFixed(1)+" tok/s";
}

$("send").onclick = send;
$("stop").onclick = ()=>{ if(aborter) aborter.abort(); };
$("prompt").addEventListener("keydown", e=>{
  if(e.key === "Enter" && !e.shiftKey){ e.preventDefault(); send(); }
});
$("newchat").onclick = ()=>{ msgs = []; render(false); saveState();
  $("stats").textContent = ""; $("err").textContent = ""; };
$("clearall").onclick = ()=>{ localStorage.removeItem(LS); msgs = [];
  render(false); };
$("dl").onclick = ()=>{
  const blob = new Blob([JSON.stringify({messages:msgs}, null, 2)],
                        {type:"application/json"});
  const a = document.createElement("a");
  a.href = URL.createObjectURL(blob); a.download = "conversation.json";
  a.click();
};
for(const k of ["sys","temp","maxtok","topk","topp","minp","reppen","apikey"])
  $(k).addEventListener("change", saveState);

loadState(); render(false); refreshProps();
</script>
</body>
</html>
"""

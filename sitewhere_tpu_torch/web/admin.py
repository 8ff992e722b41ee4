"""Minimal admin console: one static page over the existing REST surface.

The reference ships a separate admin UI application (sitewhere-admin-ui)
driving the REST APIs; this is the in-repo equivalent — a dependency-free
single page (vanilla JS, no build step) served at ``/admin`` that signs in
via ``/authapi/jwt`` and drives topology, metrics, tenants (engine
start/stop/restart), logs, and checkpoints through the same endpoints any
operator script would use.
"""

from __future__ import annotations

_PAGE = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>sitewhere-tpu admin</title>
<style>
 body{font:14px/1.45 system-ui,sans-serif;margin:0;background:#f4f5f7;color:#1b1f24}
 header{background:#1b2a41;color:#fff;padding:10px 20px;display:flex;
        align-items:center;gap:16px}
 header h1{font-size:16px;margin:0;font-weight:600}
 header .st{margin-left:auto;font-size:12px;opacity:.85}
 main{max-width:1100px;margin:18px auto;padding:0 16px;display:grid;
      grid-template-columns:1fr 1fr;gap:16px}
 section{background:#fff;border:1px solid #dfe3e8;border-radius:8px;
         padding:14px 16px}
 section h2{font-size:13px;margin:0 0 10px;text-transform:uppercase;
            letter-spacing:.05em;color:#57606a}
 table{width:100%;border-collapse:collapse;font-size:13px}
 td,th{text-align:left;padding:4px 6px;border-bottom:1px solid #eef0f3}
 th{color:#57606a;font-weight:600}
 .wide{grid-column:1/-1}
 .ok{color:#116329}.bad{color:#a40e26}
 button{font:12px system-ui;border:1px solid #c9d1d9;background:#f6f8fa;
        border-radius:6px;padding:3px 10px;cursor:pointer;margin-right:4px}
 button:hover{background:#eef1f4}
 #login{max-width:320px;margin:80px auto;background:#fff;padding:24px;
        border:1px solid #dfe3e8;border-radius:8px}
 #login input{width:100%;box-sizing:border-box;margin:6px 0 12px;
              padding:7px;border:1px solid #c9d1d9;border-radius:6px}
 pre{font-size:12px;max-height:260px;overflow:auto;background:#0d1117;
     color:#c9d1d9;padding:10px;border-radius:6px;margin:0}
 .kv{display:grid;grid-template-columns:auto 1fr;gap:2px 14px;font-size:13px}
 .kv div:nth-child(odd){color:#57606a}
</style></head><body>
<div id="login">
  <h1>sitewhere-tpu</h1>
  <input id="u" placeholder="username" value="admin">
  <input id="p" type="password" placeholder="password">
  <button onclick="signin()" style="width:100%;padding:8px">Sign in</button>
  <div id="lerr" class="bad"></div>
</div>
<div id="app" style="display:none">
<header><h1>sitewhere-tpu admin</h1><span id="inst"></span>
  <span class="st" id="stamp"></span></header>
<main>
 <section><h2>Topology</h2><div class="kv" id="topo"></div></section>
 <section><h2>Key metrics</h2><div class="kv" id="met"></div></section>
 <section class="wide"><h2>Tenant engines</h2>
   <table id="tenants"><thead><tr><th>tenant</th><th>engine</th>
   <th>actions</th></tr></thead><tbody></tbody></table></section>
 <section class="wide" id="clustersec" style="display:none">
   <h2>Cluster processes</h2>
   <table id="procs"><thead><tr><th>process</th><th>status</th>
   <th>tick</th><th>age</th><th>liveness</th></tr></thead>
   <tbody></tbody></table></section>
 <section class="wide"><h2>Pipeline rules</h2>
   <table id="rules"><thead><tr><th>token</th><th>type</th>
   <th>definition</th><th>active</th><th>actions</th></tr></thead>
   <tbody></tbody></table></section>
 <section><h2>Checkpoints</h2>
   <button onclick="ckpt()">Checkpoint now</button>
   <ul id="ckpts" style="font-size:13px"></ul></section>
 <section><h2>Recent logs</h2><pre id="logs"></pre></section>
</main></div>
<script>
let TOKEN=null;
__SHARED_JS__
const api=(p,opt={})=>fetch(p,{...opt,headers:{
  'Authorization':'Bearer '+TOKEN,'Content-Type':'application/json',
  ...(opt.headers||{})}}).then(r=>{
    if(!r.ok)throw new Error(p+' -> '+r.status);return r.json()});
async function signin(){
  const u=document.getElementById('u').value,p=document.getElementById('p').value;
  try{
    TOKEN=await mintJwt(u,p);
    document.getElementById('login').style.display='none';
    document.getElementById('app').style.display='';
    tick();setInterval(tick,2000);
  }catch(e){document.getElementById('lerr').textContent=e.message}}
function kv(el,obj){el.innerHTML=Object.entries(obj).map(
  ([k,v])=>`<div>${esc(k)}</div><div>${esc(v)}</div>`).join('')}
async function tick(){
  try{
    const t=await api('/api/instance/topology');
    document.getElementById('inst').textContent=t.instance_id;
    kv(document.getElementById('topo'),{status:t.status,
      pipeline:t.pipeline_enabled?'enabled':'disabled',
      engines:Object.keys(t.tenant_engines).length,
      failed:Object.keys(t.failed_tenant_engines).length||'none'});
    const body=document.querySelector('#tenants tbody');
    body.innerHTML=Object.entries(t.tenant_engines).map(([tok,st])=>
      `<tr><td>${esc(tok)}</td>
       <td class="${st==='STARTED'?'ok':'bad'}">${esc(st)}</td>
       <td>${['restart','stop','start'].map(op=>
         `<button data-tok="${esc(tok)}" data-op="${op}">${op}</button>`
        ).join('')}</td></tr>`).join('');
    if(t.processes){  // multi-host deployment: per-process heartbeats
      document.getElementById('clustersec').style.display='';
      document.querySelector('#procs tbody').innerHTML=
        Object.entries(t.processes).sort().map(([pid,p])=>
          `<tr><td>${esc(pid)}${pid==String(t.process_id)?' (this)':''}</td>
           <td>${esc(p.status??'?')}</td><td>${esc(p.tick??'')}</td>
           <td>${esc(p.age_s??'')}s</td>
           <td class="${p.stale?'bad':'ok'}">${p.stale?'STALE':'live'}</td>
           </tr>`).join('');
    }
    const m=await api('/api/instance/metrics');
    const pick={};
    for(const cat of Object.values(m)){           // {counters:{...},...}
      for(const [k,v] of Object.entries(cat||{})){
        if(/events|processed|alerts|dropped|drain|step/.test(k)){
          pick[k]=typeof v==='object'?(v.count??JSON.stringify(v)):v;}
        if(Object.keys(pick).length>=10)break;}}
    if(!Object.keys(pick).length)pick['(no activity yet)']='';
    kv(document.getElementById('met'),pick);
    const lg=await api('/api/instance/logs?limit=12');
    document.getElementById('logs').textContent=
      lg.records.map(r=>`${r.level??''} ${r.message??JSON.stringify(r)}`)
        .join('\\n')||'(no records)';
    try{const r=await api('/api/rules');
      const rows=[...(r.threshold||[]).map(x=>[x,'threshold',
          `${esc(x.measurement_name||'any')} ${esc(x.operator)} ${esc(x.threshold)}`]),
        ...(r.geofence||[]).map(x=>[x,'geofence',
          `${esc(x.condition)} zone ${esc(x.zone_token)}`])];
      document.querySelector('#rules tbody').innerHTML=rows.map(
        ([x,kind,def])=>`<tr><td>${esc(x.token)}</td><td>${kind}</td>
         <td>${def} → ${esc(x.alert_type)}</td>
         <td class="${x.active?'ok':'bad'}">${x.active?'yes':'no'}</td>
         <td><button data-rule="${esc(x.token)}">delete</button></td></tr>`
        ).join('')||'<tr><td colspan="5">(none)</td></tr>';}catch(e){}
    try{const c=await api('/api/instance/checkpoints');
      document.getElementById('ckpts').innerHTML=
        (c.checkpoints||[]).map(x=>`<li>${esc(x)}</li>`).join('')||
        '<li>(none)</li>';}catch(e){}
    document.getElementById('stamp').textContent=
      new Date().toLocaleTimeString();
  }catch(e){document.getElementById('stamp').textContent=e.message}}
document.addEventListener('click',ev=>{
  const b=ev.target.closest('button[data-tok]');
  if(b)eng(b.dataset.tok,b.dataset.op);
  const r=ev.target.closest('button[data-rule]');
  if(r)delRule(r.dataset.rule);});
async function delRule(tok){
  try{await api(`/api/rules/${encodeURIComponent(tok)}`,
                {method:'DELETE'});}
  catch(e){alert(e.message)}tick();}
async function eng(tok,op){
  try{await api(`/api/tenants/${encodeURIComponent(tok)}/engine/${op}`,
                {method:'POST'});}
  catch(e){alert(e.message)}tick();}
async function ckpt(){
  try{await api('/api/instance/checkpoint',{method:'POST'});}
  catch(e){alert(e.message)}tick();}
</script></body></html>
"""


def register_admin(router) -> None:
    """Serve the console at /admin (the page itself is public; every API
    call it makes carries the JWT it mints on sign-in)."""

    from sitewhere_tpu_torch.web.pagejs import ESC_JS, MINT_JWT_JS

    page = _PAGE.replace("__SHARED_JS__", ESC_JS + MINT_JWT_JS)

    def admin_page(request):
        return 200, page.encode("utf-8"), "text/html; charset=utf-8"

    router.get("/admin", admin_page, auth=False)

"""API explorer: a browsable, executable view of the REST surface.

Reference: service-web-rest ships Swagger UI over its springfox OpenAPI
document; here the same role is a single self-contained page (vanilla
JS, no CDN — the deployment may have zero egress) served at
``/api/explorer`` that renders the live ``/api/openapi.json`` route
table grouped by tag, expands each operation's parameters and body
schema, and offers try-it-out with a JWT minted via ``/authapi/jwt``.
"""

from __future__ import annotations

from sitewhere_tpu_torch.web.pagejs import ESC_JS, MINT_JWT_JS

_PAGE = r"""<!doctype html><html><head><meta charset="utf-8">
<title>sitewhere-tpu API explorer</title><style>
 body{font:14px/1.45 system-ui,sans-serif;margin:0;background:#f6f7f9;
      color:#1c2733}
 header{background:#16324f;color:#fff;padding:10px 18px;display:flex;
        gap:14px;align-items:center}
 header h1{font-size:15px;margin:0;font-weight:600}
 header input{border:0;border-radius:4px;padding:5px 8px;font-size:13px}
 header button{border:0;border-radius:4px;padding:5px 12px;cursor:pointer}
 #authstate{font-size:12px;opacity:.85}
 main{max-width:1060px;margin:14px auto;padding:0 14px}
 .tag{background:#fff;border:1px solid #dfe3e8;border-radius:8px;
      margin-bottom:12px;overflow:hidden}
 .tag>h2{font-size:13px;margin:0;padding:9px 14px;cursor:pointer;
      text-transform:uppercase;letter-spacing:.04em;color:#4a5a6a}
 .op{border-top:1px solid #eef1f4;padding:8px 14px}
 .op>.line{cursor:pointer;display:flex;gap:10px;align-items:baseline}
 .m{font-weight:700;font-size:12px;width:58px;text-align:center;
    border-radius:4px;padding:2px 0;color:#fff}
 .m.get{background:#2e7d32}.m.post{background:#1565c0}
 .m.put{background:#ef6c00}.m.delete{background:#c62828}
 .path{font-family:ui-monospace,monospace;font-size:13px}
 .sum{color:#6b7a89;font-size:12px}
 .detail{display:none;margin:8px 0 4px 68px;font-size:13px}
 .detail textarea{width:95%;font-family:ui-monospace,monospace;
    font-size:12px;min-height:60px}
 .detail input{font-family:ui-monospace,monospace;font-size:12px;
    margin:2px 4px 2px 0}
 .detail pre{background:#0f1c28;color:#d7e3ee;padding:8px;
    border-radius:6px;overflow:auto;max-height:340px;font-size:12px}
 .detail button{border:0;border-radius:4px;background:#16324f;color:#fff;
    padding:5px 14px;cursor:pointer;margin:6px 0}
 .auth{font-size:11px;color:#8a62121f;background:#fff3df;color:#8a6212;
    border-radius:4px;padding:1px 6px}
 #filter{margin:0 0 12px;width:100%;padding:7px 10px;border:1px solid
    #dfe3e8;border-radius:6px;font-size:13px}
</style></head><body>
<header><h1>sitewhere-tpu API</h1>
 <input id="u" placeholder="username" value="admin">
 <input id="p" type="password" placeholder="password" value="password">
 <button onclick="signin()">Sign in</button>
 <span id="authstate">anonymous</span>
</header>
<main>
 <input id="filter" placeholder="filter paths…" oninput="render()">
 <div id="tags"></div>
</main>
<script>
let TOKEN=null,DOC=null;
__SHARED_JS__
async function signin(){
  const u=document.getElementById('u').value,
        p=document.getElementById('p').value;
  try{
    TOKEN=await mintJwt(u,p);
    document.getElementById('authstate').textContent='signed in as '+u;
  }catch(e){document.getElementById('authstate').textContent=e.message}}
function opId(m,p){return (m+p).replace(/[^a-z0-9]/gi,'_')}
function render(){
  if(!DOC)return;  // openapi doc not loaded yet (filter typed early)
  const q=document.getElementById('filter').value.toLowerCase();
  const groups={};
  for(const [path,ops] of Object.entries(DOC.paths||{})){
    if(q&&!path.toLowerCase().includes(q))continue;
    for(const [method,op] of Object.entries(ops)){
      const tag=(op.tags&&op.tags[0])||path.split('/')[2]||'misc';
      (groups[tag]=groups[tag]||[]).push([method,path,op]);}}
  document.getElementById('tags').innerHTML=
    Object.keys(groups).sort().map(tag=>`<div class="tag">
     <h2>${esc(tag)} (${groups[tag].length})</h2>
     ${groups[tag].sort((a,b)=>a[1]<b[1]?-1:1).map(([m,p,op])=>{
       const id=opId(m,p);
       const params=(op.parameters||[]).filter(x=>x.in==='path');
       return `<div class="op">
        <div class="line" onclick="toggle('${id}')">
         <span class="m ${m}">${m.toUpperCase()}</span>
         <span class="path">${esc(p)}</span>
         <span class="sum">${esc(op.summary||'')}</span>
         ${op.security&&op.security.length?
           '<span class="auth">JWT</span>':''}
        </div>
        <div class="detail" id="${id}">
         ${params.map(x=>`<label>${esc(x.name)}
           <input data-param="${esc(x.name)}" placeholder="${esc(x.name)}">
           </label>`).join('')}
         ${['post','put'].includes(m)?
           '<div><textarea data-body placeholder="JSON body"></textarea></div>':''}
         <button onclick="call('${m}','${esc(p)}','${id}')">Send</button>
         <pre data-out>—</pre>
        </div></div>`}).join('')}
    </div>`).join('')||'<p>(no matching paths)</p>';}
function toggle(id){
  const el=document.getElementById(id);
  el.style.display=el.style.display==='block'?'none':'block';}
async function call(method,path,id){
  const el=document.getElementById(id);
  for(const inp of el.querySelectorAll('input[data-param]'))
    path=path.replace('{'+inp.dataset.param+'}',
                      ()=>encodeURIComponent(inp.value));
  const opt={method:method.toUpperCase(),headers:{}};
  if(TOKEN)opt.headers['Authorization']='Bearer '+TOKEN;
  const body=el.querySelector('textarea[data-body]');
  if(body&&body.value.trim()){
    opt.headers['Content-Type']='application/json';opt.body=body.value;}
  const out=el.querySelector('pre[data-out]');
  try{
    const r=await fetch(path,opt);
    const text=await r.text();
    let shown=text;
    try{shown=JSON.stringify(JSON.parse(text),null,2)}catch(e){}
    out.textContent=r.status+' '+r.statusText+'\n\n'+
      shown.slice(0,20000);
  }catch(e){out.textContent=String(e)}}
fetch('/api/openapi.json').then(r=>r.json()).then(doc=>{
  DOC=doc;render();}).catch(e=>{
  document.getElementById('tags').textContent=
    'failed to load /api/openapi.json: '+e;});
</script></body></html>
"""


def register_explorer(router) -> None:
    """Serve the explorer at /api/explorer (the page itself is public,
    like the OpenAPI document it renders; every call it makes carries the
    JWT minted on sign-in)."""

    page = _PAGE.replace("__SHARED_JS__", ESC_JS + MINT_JWT_JS)

    def explorer_page(request):
        return 200, page.encode("utf-8"), "text/html; charset=utf-8"

    router.get("/api/explorer", explorer_page, auth=False)

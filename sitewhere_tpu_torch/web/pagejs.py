"""Shared JS fragments for the self-contained operator pages (/admin,
/api/explorer). Both pages inline their scripts — no CDN, the deployment
may have zero egress — so shared behavior lives here once: the
HTML-escape helper (operator data interpolated into markup must never
execute with the page's JWT in scope) and the Basic-auth -> JWT mint
against /authapi/jwt.
"""

ESC_JS = r"""
const esc=s=>String(s).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
"""

MINT_JWT_JS = r"""
async function mintJwt(u,p){
  const r=await fetch('/authapi/jwt',{method:'POST',
    headers:{'Authorization':'Basic '+btoa(u+':'+p)}});
  if(!r.ok)throw new Error('auth failed ('+r.status+')');
  return (await r.json()).token;}
"""

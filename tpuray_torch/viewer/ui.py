"""The viewer's single page, HTML and JavaScript with no external assets
(counterpart of tpuray/viewer/ui.py, the same page byte for byte): the
parameter sliders, the debug-view menu, mouse and keyboard camera control
and the ms/frame readout of the original renderer's window, talking to
viewer/server.py over HTTP with the same element ids and control events.
"""

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpuray viewer</title>
<style>
 body{margin:0;background:#16181d;color:#d6d8de;font:13px system-ui,sans-serif;
      display:flex;min-height:100vh}
 #view{flex:1;display:flex;align-items:center;justify-content:center}
 #frame{image-rendering:pixelated;max-width:95%;max-height:95vh;
        outline:1px solid #2a2d35;cursor:grab}
 #panel{width:300px;padding:14px;background:#1c1f26;overflow-y:auto}
 h1{font-size:14px;margin:0 0 10px}
 .row{margin:7px 0}
 label{display:block;font-size:11px;color:#9aa0ac;margin-bottom:2px}
 input[type=range]{width:100%}
 select,button{width:100%;background:#262a33;color:#d6d8de;border:1px solid #343945;
        border-radius:4px;padding:4px}
 .val{float:right;color:#7ab3ff}
 #stats{font-size:11px;color:#9aa0ac;white-space:pre;margin-top:10px;
        border-top:1px solid #2a2d35;padding-top:8px}
 .chk{display:flex;align-items:center;gap:6px}
 .chk label{margin:0}
</style></head><body>
<div id="view"><img id="frame" width="16" height="16" draggable="false"></div>
<div id="panel">
 <h1>tpuray — path tracing + SVGF</h1>
 <div class="row"><label>debug view</label>
  <select id="view_sel">
   <option value="0">path tracing 1spp</option>
   <option value="1">svgf reprojected</option>
   <option value="2">svgf variance</option>
   <option value="3">svgf a-trous</option>
   <option value="4">svgf modulate</option>
   <option value="5">taa</option>
   <option value="6" selected>final</option>
   <option value="7">accumulated color</option>
  </select></div>
 SLIDERS
 <div class="row chk"><input type="checkbox" id="accumulate" checked>
  <label for="accumulate">accumulate</label></div>
 <div class="row chk"><input type="checkbox" id="use_normal_map">
  <label for="use_normal_map">normal map</label></div>
 <div class="row"><button id="reset">reset accumulation</button></div>
 <div id="stats">connecting…</div>
 <div style="font-size:11px;color:#6b7180;margin-top:8px">
  drag = orbit · wheel = dolly · WASD = pan</div>
</div>
<script>
const $=id=>document.getElementById(id);
let seq=-1, dragging=false, lx=0, ly=0;
function post(o){fetch('/control',{method:'POST',body:JSON.stringify(o)});}
function poll(){
 fetch('/frame.png?seq='+seq).then(r=>{
  if(r.status==204){setTimeout(poll,50);return null;}
  seq=+r.headers.get('X-Seq');
  const st=r.headers.get('X-Stats');
  if(st)$('stats').textContent=JSON.parse(st).text;
  return r.blob();
 }).then(b=>{
  if(!b)return;
  const u=URL.createObjectURL(b);
  const im=$('frame');
  const old=im.src; im.onload=()=>{if(old)URL.revokeObjectURL(old);};
  im.src=u; setTimeout(poll,10);
 }).catch(()=>setTimeout(poll,500));
}
poll();
const im=$('frame');
im.addEventListener('pointerdown',e=>{dragging=true;lx=e.clientX;ly=e.clientY;
 im.setPointerCapture(e.pointerId);});
im.addEventListener('pointerup',()=>dragging=false);
im.addEventListener('pointermove',e=>{
 if(!dragging)return;
 post({type:'rotate',dx:(e.clientX-lx)*0.25,dy:(e.clientY-ly)*0.25});
 lx=e.clientX;ly=e.clientY;});
im.addEventListener('wheel',e=>{e.preventDefault();
 post({type:'dolly',d:e.deltaY<0?0.1:-0.1});},{passive:false});
window.addEventListener('keydown',e=>{
 const k=e.key.toLowerCase();
 const m={w:[0.05,0],s:[-0.05,0],a:[0,-0.05],d:[0,0.05]};
 if(m[k])post({type:'pan',forward:m[k][0],right:m[k][1]});});
$('view_sel').addEventListener('change',e=>post({type:'view',view:+e.target.value}));
$('reset').addEventListener('click',()=>post({type:'reset'}));
for(const id of ['accumulate','use_normal_map'])
 $(id).addEventListener('change',e=>post({type:'param',name:id,value:e.target.checked}));
function slider(id){
 const el=$(id);
 el.addEventListener('input',e=>{
  $(id+'_v').textContent=e.target.value;
  post({type:'param',name:id,value:+e.target.value});});
}
SLIDER_HOOKS
fetch('/state').then(r=>r.json()).then(s=>{
 for(const [k,v] of Object.entries(s.params)){
  const el=$(k);
  if(!el)continue;
  if(el.type=='checkbox')el.checked=v;
  else{el.value=v;const t=$(k+'_v');if(t)t.textContent=v;}
 }
 $('view_sel').value=s.view;
});
</script></body></html>"""

# (label, id, min, max, step) — ranges mirror the imgui sliders
# (main.cpp:372-387)
SLIDERS = [
    ("max tracing depth", "max_tracing_depth", 1, 4, 1),
    ("a-trous iterations", "num_atrous_iterations", 2, 8, 1),
    ("sigma normal (phi_n)", "sigma_n", 1, 256, 1),
    ("sigma luminance (phi_l)", "sigma_l", 0.1, 16, 0.1),
    ("reproject depth threshold", "reproj_depth_threshold", 0.1, 30, 0.1),
    ("reproject normal threshold", "reproj_normal_threshold", 0.1, 64, 0.1),
    ("radiance clamp", "clamp_threshold", 0.5, 40, 0.5),
]


def render_page() -> str:
    rows, hooks = [], []
    for label, sid, lo, hi, step in SLIDERS:
        rows.append(
            f'<div class="row"><label>{label}'
            f'<span class="val" id="{sid}_v"></span></label>'
            f'<input type="range" id="{sid}" min="{lo}" max="{hi}" step="{step}">'
            f"</div>")
        hooks.append(f"slider('{sid}');")
    return (PAGE.replace("SLIDERS", "\n".join(rows))
                .replace("SLIDER_HOOKS", "\n".join(hooks)))

"""Interactive web viewer: the Pangolin GL window equivalent.

Port of `vslam_tpu/viz/web.py`: the same page, byte for byte, for the
same run. The reference opens a live Pangolin window with a UI panel
(Follow Camera / Restart / Top View / Side View / Reset View / Show
Dense / Show Sparse, `src/Viewer.cpp:60-66`), trajectory line + keyframe
frustums + EMA current frustum (`Viewer.cpp:244-253`), height-colored
dense points (`Viewer.cpp:328-344`), cyan sparse points, and follow-cam
modes (`Viewer.cpp:402-437`). Headless, the interactive surface is
exported instead as ONE self-contained HTML file (no external assets,
works offline): a canvas 3D point/line renderer with mouse
orbit/pan/zoom, the same UI panel, a playback timeline scrubbing the
trajectory, and the per-frame HUD text block (`src/main.cpp:1220-1260`).

Data is embedded as base64 typed arrays; a ~60k-point scene is a few MB
and renders at interactive rates in any browser.
"""

from __future__ import annotations

import base64
import json
from types import SimpleNamespace

import numpy as np

def _b64(arr, dtype):
    return base64.b64encode(np.ascontiguousarray(arr, dtype=dtype).tobytes()).decode()


def _height_rgb(y):
    """Viridis-like height ramp, precomputed host-side (Viewer.cpp:328-344).
    Needs matplotlib; the app always passes the dense cloud's own colours,
    so it never reaches this."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lo, hi = np.percentile(y, 5), np.percentile(y, 95)
    tt = np.clip((y - lo) / max(hi - lo, 1e-6), 0, 1)
    return (plt.cm.viridis(1.0 - tt)[:, :3] * 255).astype(np.uint8)


def export_web_viewer(
    out_path,
    trajectory,
    *,
    timestamps=None,
    gt_trajectory=None,
    kf_R=None,
    kf_t=None,
    sparse_xyz=None,
    dense_xyz=None,
    dense_rgb=None,
    loop_edges=None,
    hud_lines=None,
    title="vslam_tpu viewer",
    max_points=120_000,
):
    """Write a single-file interactive HTML viewer; returns `out_path`.

    `hud_lines`: optional list (one entry per frame) of lists of HUD text
    lines shown while scrubbing (see `viewer.hud_text`).
    """
    traj = np.asarray(trajectory, np.float32).reshape(-1, 3)
    N = len(traj)
    rng = np.random.default_rng(0)

    def _cap(x, extra=None):
        if x is None:
            return None, extra
        x = np.asarray(x)
        if len(x) > max_points:
            sel = rng.choice(len(x), max_points, replace=False)
            return x[sel], (None if extra is None else np.asarray(extra)[sel])
        return x, (None if extra is None else np.asarray(extra))

    dense_xyz, dense_rgb = _cap(dense_xyz, dense_rgb)
    sparse_xyz, _ = _cap(sparse_xyz)

    data = {"n": N, "traj": _b64(traj, np.float32)}
    if timestamps is not None:
        data["ts"] = _b64(np.asarray(timestamps)[:N], np.float32)
    if gt_trajectory is not None:
        g = np.asarray(gt_trajectory, np.float32).reshape(-1, 3)
        data["gt"] = _b64(g, np.float32)
        data["gtn"] = len(g)
    if kf_t is not None:
        kf_t = np.asarray(kf_t, np.float32).reshape(-1, 3)
        data["kft"] = _b64(kf_t, np.float32)
        data["kfn"] = len(kf_t)
        if kf_R is not None:
            data["kfr"] = _b64(np.asarray(kf_R, np.float32), np.float32)
    if sparse_xyz is not None and len(sparse_xyz):
        data["sp"] = _b64(sparse_xyz, np.float32)
        data["spn"] = len(sparse_xyz)
    if dense_xyz is not None and len(dense_xyz):
        data["dn"] = _b64(dense_xyz, np.float32)
        data["dnn"] = len(dense_xyz)
        rgb = (
            np.asarray(dense_rgb, np.uint8)
            if dense_rgb is not None
            else _height_rgb(-np.asarray(dense_xyz)[:, 1])
        )
        data["dnc"] = _b64(rgb, np.uint8)
    if loop_edges:
        le = np.asarray(
            [[p, q] for p, q in loop_edges], np.float32
        ).reshape(-1, 6)
        data["loops"] = _b64(le, np.float32)
        data["loopn"] = len(le)
    if hud_lines is not None:
        data["hud"] = [list(map(str, ls)) for ls in hud_lines]

    html = (
        _TEMPLATE.replace("__TITLE__", title)
        .replace("__DATA__", json.dumps(data))
    )
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def _host(x):
    """A tensor (any device) or array -> numpy: one read back."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def export_run(result, out_path, seq=None, dense=None, gt_trajectory=None,
               title="vslam_tpu run"):
    """Export a `core.pipeline.RunResult` (plus optional GT sequence and
    dense cloud `(xyz, rgb)`) as an interactive HTML viewer. The run's
    StepOutputs and final state are read back from the card once, a field
    at a time (only the fields the page shows), never per frame."""
    from vslam_tpu_torch.viz.viewer import HUD_FIELDS, hud_text, loop_edges_from_state

    st = result.final_state
    kf_valid = _host(st.keyframes.valid)
    N = result.t.shape[0]
    outs_np = SimpleNamespace(**{name: _host(getattr(result.outputs, name))
                                 for name in HUD_FIELDS})
    hud = [hud_text(outs_np, i) for i in range(N)]
    if gt_trajectory is None and seq is not None:
        gt_trajectory = seq.t
    return export_web_viewer(
        out_path,
        result.t_smoothed,
        timestamps=result.timestamps,
        gt_trajectory=gt_trajectory,
        kf_R=_host(st.keyframes.R)[kf_valid],
        kf_t=_host(st.keyframes.t)[kf_valid],
        sparse_xyz=_host(st.map.pos)[_host(st.map.valid)],
        dense_xyz=None if dense is None else dense[0],
        dense_rgb=None if dense is None else dense[1],
        loop_edges=loop_edges_from_state(st) or None,
        hud_lines=hud,
        title=title,
    )


# One self-contained page: decode base64 typed arrays, software-project
# points into a canvas pixel buffer, orbit/pan/zoom with the mouse, and
# mirror the reference UI panel (Viewer.cpp:60-66) + HUD (main.cpp:1220).
_TEMPLATE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
body{margin:0;background:#000;color:#ddd;font:12px monospace;overflow:hidden}
#panel{position:fixed;left:8px;top:8px;background:rgba(20,20,20,.85);
padding:8px;border:1px solid #333;border-radius:4px;z-index:2;width:150px}
#panel button,#panel label{display:block;width:100%;margin:2px 0;font:inherit}
#panel button{background:#222;color:#ddd;border:1px solid #444;padding:3px;
cursor:pointer}#panel button:hover{background:#333}
#hud{position:fixed;right:8px;top:8px;background:rgba(20,20,20,.7);
padding:8px;white-space:pre;z-index:2;color:#fff}
#bar{position:fixed;left:0;right:0;bottom:0;background:rgba(20,20,20,.85);
padding:6px 10px;z-index:2;display:flex;gap:8px;align-items:center}
#frame{flex:1}
canvas{position:fixed;left:0;top:0}
</style></head><body>
<div id="panel">
 <button id="bFollow">Follow Camera: ON</button>
 <button id="bTop">Top View</button>
 <button id="bSide">Side View</button>
 <button id="bReset">Reset View</button>
 <button id="bDense">Show Dense: ON</button>
 <button id="bSparse">Show Sparse: ON</button>
 <button id="bRestart">Restart</button>
</div>
<div id="hud"></div>
<div id="bar">
 <button id="bPlay">&#9654;</button>
 <input type="range" id="frame" min="0" value="0">
 <span id="fLabel"></span>
</div>
<canvas id="cv"></canvas>
<script>
const DATA = __DATA__;
function f32(b){const s=atob(b),a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
function u8(b){const s=atob(b),a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a;}
const traj=f32(DATA.traj), N=DATA.n;
const gt=DATA.gt?f32(DATA.gt):null, gtn=DATA.gtn||0;
const kft=DATA.kft?f32(DATA.kft):null, kfn=DATA.kfn||0;
const kfr=DATA.kfr?f32(DATA.kfr):null;
const sp=DATA.sp?f32(DATA.sp):null, spn=DATA.spn||0;
const dn=DATA.dn?f32(DATA.dn):null, dnn=DATA.dnn||0;
const dnc=DATA.dnc?u8(DATA.dnc):null;
const loops=DATA.loops?f32(DATA.loops):null, loopn=DATA.loopn||0;
const hud=DATA.hud||null;
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
let W,H,img,px;
function resize(){W=innerWidth;H=innerHeight;cv.width=W;cv.height=H;
 img=ctx.createImageData(W,H);px=new Uint32Array(img.data.buffer);}
resize();addEventListener('resize',()=>{resize();draw();});
// view state: yaw/pitch orbit around target, distance zoom
let yaw=-1.0,pitch=0.45,dist=8,target=[0,0,0];
let follow=true,showDense=true,showSparse=true,frame=N-1,playing=false;
function centroid(){let c=[0,0,0];for(let i=0;i<N;i++){c[0]+=traj[3*i];
 c[1]+=traj[3*i+1];c[2]+=traj[3*i+2];}return c.map(v=>v/Math.max(N,1));}
const c0=centroid();
function resetView(){yaw=-1.0;pitch=0.45;dist=8;target=c0.slice();}
resetView();
function rot(){const cy=Math.cos(yaw),sy=Math.sin(yaw),
 cp=Math.cos(pitch),sp_=Math.sin(pitch);
 // world(x,y,z) with y-down -> screen: use (x, z, -y) like the PNG viewer
 return [cy,0,sy, sy*sp_,cp,-cy*sp_, -sy*cp,sp_,cy*cp];}
function project(x,y,z,R){ // returns [sx,sy,depth] or null
 const wx=x-target[0],wy=-(y-target[1]),wz=z-target[2]; // y flip
 const vx=R[0]*wx+R[1]*wy+R[2]*wz, vy=R[3]*wx+R[4]*wy+R[5]*wz,
       vz=R[6]*wx+R[7]*wy+R[8]*wz+dist;
 if(vz<0.05)return null;
 const f=0.9*Math.min(W,H)/vz;
 return [W/2+vx*f,H/2-vy*f,vz];}
function putpt(sx,sy,color,size){const x0=sx|0,y0=sy|0;
 for(let dy=0;dy<size;dy++)for(let dx=0;dx<size;dx++){
  const x=x0+dx,y=y0+dy;
  if(x>=0&&x<W&&y>=0&&y<H)px[y*W+x]=color;}}
function rgba(r,g,b){return (255<<24)|(b<<16)|(g<<8)|r;}
function drawPts(arr,n,R,colArr,col,size){
 for(let i=0;i<n;i++){const p=project(arr[3*i],arr[3*i+1],arr[3*i+2],R);
  if(!p)continue;
  const c=colArr?rgba(colArr[3*i],colArr[3*i+1],colArr[3*i+2]):col;
  putpt(p[0],p[1],c,size);}}
function line(a,b,R,style,w){const p=project(a[0],a[1],a[2],R),
 q=project(b[0],b[1],b[2],R);if(!p||!q)return;
 ctx.strokeStyle=style;ctx.lineWidth=w;ctx.beginPath();
 ctx.moveTo(p[0],p[1]);ctx.lineTo(q[0],q[1]);ctx.stroke();}
function polyline(arr,n,R,style,w){ctx.strokeStyle=style;ctx.lineWidth=w;
 ctx.beginPath();let started=false;
 for(let i=0;i<n;i++){const p=project(arr[3*i],arr[3*i+1],arr[3*i+2],R);
  if(!p){started=false;continue;}
  if(!started){ctx.moveTo(p[0],p[1]);started=true;}
  else ctx.lineTo(p[0],p[1]);}
 ctx.stroke();}
function frustum(Rc,t,scale,R,style,w){ // camera-to-world Rc (3x3), t (3)
 const wdt=0.8*scale,hgt=0.6*scale,z=scale;
 const cs=[[0,0,0],[wdt,hgt,z],[-wdt,hgt,z],[-wdt,-hgt,z],[wdt,-hgt,z]];
 const pts=cs.map(c=>[
  Rc[0]*c[0]+Rc[1]*c[1]+Rc[2]*c[2]+t[0],
  Rc[3]*c[0]+Rc[4]*c[1]+Rc[5]*c[2]+t[1],
  Rc[6]*c[0]+Rc[7]*c[1]+Rc[8]*c[2]+t[2]]);
 const segs=[[0,1],[0,2],[0,3],[0,4],[1,2],[2,3],[3,4],[4,1]];
 for(const[a,b]of segs)line(pts[a],pts[b],R,style,w);}
let emaT=null; const I3=[1,0,0,0,1,0,0,0,1];
function draw(){
 const R=rot();
 if(follow){const i=Math.min(frame,N-1);
  target=[traj[3*i],traj[3*i+1],traj[3*i+2]];}
 px.fill(0xff000000);
 if(showDense&&dn)drawPts(dn,dnn,R,dnc,0,1);
 if(showSparse&&sp)drawPts(sp,spn,R,null,rgba(0,255,255),2);
 ctx.putImageData(img,0,0);
 polyline(traj,Math.min(frame+1,N),R,'#32ff32',1.5);
 if(gt)polyline(gt,gtn,R,'rgba(255,165,0,.8)',1);
 if(kft)for(let k=0;k<kfn;k++){
  const Rc=kfr?kfr.slice(9*k,9*k+9):I3;
  frustum(Rc,[kft[3*k],kft[3*k+1],kft[3*k+2]],0.09,R,'#00bfff',0.6);}
 if(loops)for(let k=0;k<loopn;k++)
  line([loops[6*k],loops[6*k+1],loops[6*k+2]],
       [loops[6*k+3],loops[6*k+4],loops[6*k+5]],R,'#ff00ff',1.2);
 // EMA current frustum (Viewer.cpp:244-253)
 const i=Math.min(frame,N-1),ct=[traj[3*i],traj[3*i+1],traj[3*i+2]];
 if(!emaT)emaT=ct.slice();
 for(let k=0;k<3;k++)emaT[k]=0.85*emaT[k]+0.15*ct[k];
 frustum(I3,emaT,0.15,R,'#ff3030',1.8);
 document.getElementById('fLabel').textContent=
  'frame '+i+' / '+(N-1);
 document.getElementById('hud').textContent=
  hud&&hud[i]?hud[i].join('\n'):'';
}
// --- UI panel (Viewer.cpp:60-66 equivalents) ---
const $=id=>document.getElementById(id);
$('bFollow').onclick=()=>{follow=!follow;
 $('bFollow').textContent='Follow Camera: '+(follow?'ON':'OFF');draw();};
$('bTop').onclick=()=>{pitch=1.55;yaw=-Math.PI/2;draw();};
$('bSide').onclick=()=>{pitch=0.0;yaw=-Math.PI/2;draw();};
$('bReset').onclick=()=>{resetView();emaT=null;draw();};
$('bDense').onclick=()=>{showDense=!showDense;
 $('bDense').textContent='Show Dense: '+(showDense?'ON':'OFF');draw();};
$('bSparse').onclick=()=>{showSparse=!showSparse;
 $('bSparse').textContent='Show Sparse: '+(showSparse?'ON':'OFF');draw();};
$('bRestart').onclick=()=>{frame=0;$('frame').value=0;emaT=null;
 resetView();playing=true;$('bPlay').innerHTML='&#10074;&#10074;';draw();};
const slider=$('frame');slider.max=N-1;slider.value=N-1;
slider.oninput=()=>{frame=+slider.value;draw();};
$('bPlay').onclick=()=>{playing=!playing;
 $('bPlay').innerHTML=playing?'&#10074;&#10074;':'&#9654;';};
setInterval(()=>{if(playing){frame=(frame+1)%N;slider.value=frame;draw();}},50);
// --- mouse orbit / pan / zoom ---
let drag=null;
cv.onmousedown=e=>{drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};};
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
 if(drag.shift){const R=rot(),s=dist/(0.9*Math.min(W,H));
  target[0]-=s*(R[0]*dx-R[3]*dy);target[1]+=s*(R[1]*dx-R[4]*dy);
  target[2]-=s*(R[2]*dx-R[5]*dy);follow=false;
  $('bFollow').textContent='Follow Camera: OFF';}
 else{yaw+=dx*0.008;pitch=Math.max(-1.55,Math.min(1.55,pitch+dy*0.008));}
 drag={x:e.clientX,y:e.clientY,shift:drag.shift};draw();});
cv.onwheel=e=>{dist*=Math.pow(1.1,e.deltaY>0?1:-1);
 dist=Math.max(0.3,Math.min(200,dist));draw();e.preventDefault();};
draw();
</script></body></html>
"""

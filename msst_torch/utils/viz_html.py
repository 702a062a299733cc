"""Interactive map viewer (the reference's live RViz surface, headless).

The reference's operator UI is RViz subscribed to the mapping node's
visualization topics — the 0.2 Hz global map, the path, loop-closure
markers (``mapOptmization.cpp:421-490,723-774``).  This module provides the
interactive equivalent with zero external dependencies: a self-contained
WebGL page (no CDN — this environment and many robots have no egress) that
renders the streamed ``global_map.ply`` + ``trajectory.json`` artifacts
written by the ``--viz-every`` path and live-reloads them as the run
overwrites them, plus a tiny no-cache HTTP server (``msst-torch viz-serve``).

Controls: drag = orbit, right-drag/shift-drag = pan, wheel = zoom,
[t] top-down, [p] point size, live poll every 2 s (toggle with [l]).

The port's own copy of ``msst_tpu.utils.viz_html``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

import json
import os

import numpy as np

VIEWER_HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>msst_torch map viewer</title><style>
 html,body{margin:0;height:100%;overflow:hidden;background:#101014;
   font:12px/1.4 system-ui,sans-serif;color:#d8d8e0}
 #hud{position:fixed;top:8px;left:10px;user-select:none;white-space:pre}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<canvas id="c"></canvas><div id="hud">loading…</div>
<script>
"use strict";
const cv=document.getElementById("c"),hud=document.getElementById("hud");
const gl=cv.getContext("webgl",{antialias:true});
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
 gl.compileShader(o);if(!gl.getShaderParameter(o,gl.COMPILE_STATUS))
 throw gl.getShaderInfoLog(o);return o;}
const vs=`attribute vec3 p;uniform mat4 mvp;uniform float ps;
 uniform vec2 zr;varying vec3 col;
 vec3 turbo(float t){t=clamp(t,0.,1.);
  return clamp(vec3(1.6*t-.1, 1.8-abs(t-.55)*3.2, 1.3-1.6*t),0.,1.);}
 void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;
  col=turbo((p.z-zr.x)/max(zr.y-zr.x,1e-3));}`;
const fs=`precision mediump float;varying vec3 col;uniform vec3 fixedCol;
 uniform float useFixed;
 void main(){gl_FragColor=vec4(mix(col,fixedCol,useFixed),1.);}`;
const pr=gl.createProgram();
gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(pr);gl.useProgram(pr);
const loc={p:gl.getAttribLocation(pr,"p"),mvp:gl.getUniformLocation(pr,"mvp"),
 ps:gl.getUniformLocation(pr,"ps"),zr:gl.getUniformLocation(pr,"zr"),
 fc:gl.getUniformLocation(pr,"fixedCol"),uf:gl.getUniformLocation(pr,"useFixed")};
// --- tiny mat4 (column-major) ---
function persp(f,a,n,fr){const t=1/Math.tan(f/2),d=n-fr;return[t/a,0,0,0, 0,t,0,0,
 0,0,(fr+n)/d,-1, 0,0,2*fr*n/d,0];}
function mul(a,b){const o=new Array(16);for(let c=0;c<4;c++)for(let r=0;r<4;r++){
 let s=0;for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s;}return o;}
function lookAt(e,c){let zx=e[0]-c[0],zy=e[1]-c[1],zz=e[2]-c[2];
 let zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
 const up=Math.abs(zz)>0.999?[0,1,0]:[0,0,1];
 let xx=up[1]*zz-up[2]*zy,xy=up[2]*zx-up[0]*zz,xz=up[0]*zy-up[1]*zx;
 const xl=Math.hypot(xx,xy,xz);xx/=xl;xy/=xl;xz/=xl;
 const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 return[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0,
  -(xx*e[0]+xy*e[1]+xz*e[2]),-(yx*e[0]+yy*e[1]+yz*e[2]),
  -(zx*e[0]+zy*e[1]+zz*e[2]),1];}
// --- state ---
let cloud={buf:gl.createBuffer(),n:0},traj={buf:gl.createBuffer(),n:0};
let ctr=[0,0,0],zr=[0,1],dist=60,yaw=-0.8,pitch=0.9,pan=[0,0,0];
let psize=1.5,live=true,nPts=0,nPoses=0,lastLoad="";
function setCloud(xyz){
 gl.bindBuffer(gl.ARRAY_BUFFER,cloud.buf);
 gl.bufferData(gl.ARRAY_BUFFER,xyz,gl.STATIC_DRAW);cloud.n=xyz.length/3;
 if(cloud.n){let mn=[1/0,1/0,1/0],mx=[-1/0,-1/0,-1/0];
  for(let i=0;i<xyz.length;i+=3)for(let k=0;k<3;k++){
   if(xyz[i+k]<mn[k])mn[k]=xyz[i+k];if(xyz[i+k]>mx[k])mx[k]=xyz[i+k];}
  ctr=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
  zr=[mn[2],mx[2]];
  if(lastLoad==="")dist=1.6*Math.max(mx[0]-mn[0],mx[1]-mn[1],10);}}
function parsePLY(txt){
 const he=txt.indexOf("end_header");if(he<0)return new Float32Array(0);
 const nv=+(/element vertex (\d+)/.exec(txt)||[0,0])[1];
 const out=new Float32Array(nv*3);
 let i=txt.indexOf("\n",he)+1,w=0;
 for(let v=0;v<nv;v++){const e=txt.indexOf("\n",i);
  const parts=txt.slice(i,e<0?txt.length:e).trim().split(/\s+/);
  out[w++]=+parts[0];out[w++]=+parts[1];out[w++]=+parts[2];
  i=e+1;if(e<0)break;}
 return out.subarray(0,w);}
async function load(){
 try{
  const r=await fetch("global_map.ply",{cache:"no-store"});
  if(r.ok){const xyz=parsePLY(await r.text());nPts=xyz.length/3;setCloud(xyz);}
  const t=await fetch("trajectory.json",{cache:"no-store"});
  if(t.ok){const js=await t.json();const a=new Float32Array(js.xyz.flat());
   gl.bindBuffer(gl.ARRAY_BUFFER,traj.buf);
   gl.bufferData(gl.ARRAY_BUFFER,a,gl.STATIC_DRAW);traj.n=a.length/3;
   nPoses=traj.n;}
  lastLoad=new Date().toLocaleTimeString();
 }catch(e){lastLoad="fetch failed: "+e;}
}
function draw(){
 const w=cv.clientWidth,h=cv.clientHeight;
 if(cv.width!==w||cv.height!==h){cv.width=w;cv.height=h;gl.viewport(0,0,w,h);}
 gl.clearColor(0.063,0.063,0.078,1);gl.clear(gl.COLOR_BUFFER_BIT);
 const tgt=[ctr[0]+pan[0],ctr[1]+pan[1],ctr[2]+pan[2]];
 const eye=[tgt[0]+dist*Math.cos(pitch)*Math.cos(yaw),
            tgt[1]+dist*Math.cos(pitch)*Math.sin(yaw),
            tgt[2]+dist*Math.sin(pitch)];
 const mvp=mul(persp(0.9,w/h,0.1,dist*40),lookAt(eye,tgt));
 gl.uniformMatrix4fv(loc.mvp,false,mvp);gl.uniform2f(loc.zr,zr[0],zr[1]);
 gl.enableVertexAttribArray(loc.p);
 if(cloud.n){gl.uniform1f(loc.uf,0);gl.uniform1f(loc.ps,psize);
  gl.bindBuffer(gl.ARRAY_BUFFER,cloud.buf);
  gl.vertexAttribPointer(loc.p,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.POINTS,0,cloud.n);}
 if(traj.n){gl.uniform1f(loc.uf,1);gl.uniform3f(loc.fc,1,0.85,0.1);
  gl.bindBuffer(gl.ARRAY_BUFFER,traj.buf);
  gl.vertexAttribPointer(loc.p,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.LINE_STRIP,0,traj.n);
  gl.uniform1f(loc.ps,6);gl.drawArrays(gl.POINTS,traj.n-1,1);}
 hud.textContent=`msst_torch viewer  ${nPts} pts  ${nPoses} poses  `+
  `live=${live?"on":"off"}  loaded ${lastLoad}\n`+
  `drag orbit | shift-drag pan | wheel zoom | [t]op | [p]size | [l]ive`;
 requestAnimationFrame(draw);}
// --- input ---
let drag=null;
cv.addEventListener("mousedown",e=>{drag=[e.clientX,e.clientY,e.shiftKey||e.button===2];});
window.addEventListener("mouseup",()=>drag=null);
window.addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){const s=dist/600;
  pan[0]+=(-dx*Math.sin(yaw)-dy*Math.cos(yaw)*Math.sin(pitch))*s;
  pan[1]+=( dx*Math.cos(yaw)-dy*Math.sin(yaw)*Math.sin(pitch))*s;
  pan[2]+=dy*Math.cos(pitch)*s;}
 else{yaw-=dx*0.006;pitch=Math.min(1.55,Math.max(-1.55,pitch+dy*0.006));}
 drag=[e.clientX,e.clientY,drag[2]];});
cv.addEventListener("contextmenu",e=>e.preventDefault());
cv.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*0.001);
 e.preventDefault();},{passive:false});
window.addEventListener("keydown",e=>{
 if(e.key==="t"){pitch=1.55;yaw=-Math.PI/2;}
 if(e.key==="p")psize=psize>=4?1.5:psize+0.5;
 if(e.key==="l")live=!live;});
load();setInterval(()=>{if(live)load();},2000);draw();
</script></body></html>
"""


def write_trajectory_json(path: str, est_xyz: np.ndarray):
    """Trajectory positions for the viewer (atomic write-then-rename, like
    the PLY stream)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"xyz": np.asarray(est_xyz, dtype=float).round(4).tolist()},
                  f)
    os.replace(tmp, path)


def write_viewer(directory: str) -> str:
    os.makedirs(directory, exist_ok=True)
    out = os.path.join(directory, "viewer.html")
    with open(out, "w") as f:
        f.write(VIEWER_HTML)
    return out


def make_server(directory: str, port: int = 8642):
    """No-cache HTTP server over the viz directory (live reload relies on
    refetching the overwritten artifacts).  Returns the (unstarted) server;
    port 0 picks a free port (``srv.server_address[1]``)."""
    import http.server

    write_viewer(directory)

    class H(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=directory, **kw)

        def end_headers(self):
            self.send_header("Cache-Control", "no-store")
            super().end_headers()

        def log_message(self, *a):
            pass

    return http.server.ThreadingHTTPServer(("127.0.0.1", port), H)


def serve(directory: str, port: int = 8642):
    """Blocking viewer server; Ctrl-C to stop."""
    srv = make_server(directory, port)
    print(f"viewer: http://127.0.0.1:{srv.server_address[1]}/viewer.html  "
          f"(serving {directory}; Ctrl-C stops)")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()

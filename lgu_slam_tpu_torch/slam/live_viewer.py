"""Live interactive reconstruction viewer (port of the JAX package's
``slam/live_viewer.py``; reference: droid_slam/visualization.py, the Open3D
droid_visualization process).

A zero-dependency web viewer in place of the reference's Open3D window:

* :class:`LiveViewer` wraps an :class:`IncrementalReconstruction`
  (``slam/visualization.py``) and serves it over stdlib ``http.server`` on
  a background daemon thread.
* ``GET /`` returns an embedded single-file WebGL page (orbiting point
  cloud and camera frusta, no external JS).
* ``GET /cloud`` returns a versioned binary snapshot (little-endian:
  ``u32 version, u32 n_points, u32 n_cams``, then ``f32 xyz * n``,
  ``u8 rgb * n``, ``f32 [centre, rotation columns] * n_cams``), or 304
  when the client's ``?have=`` already is the version.  The page polls it
  and re-uploads its buffers only when the version advances.
* Any other path: 404 (the JAX viewer serves its page there).

The SLAM loop calls :meth:`LiveViewer.refresh` where the reference signals
its viewer (after each tracked frame and after ``terminate()``): refresh
consumes ``video.dirty`` through the incremental reconstruction and bumps
the version when a frame changed.
"""

from __future__ import annotations

import http.server
import socket
import struct
import threading

import numpy as np
import torch

from lgu_slam_tpu_torch import lie

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>lgu-slam-tpu live</title>
<style>
 html,body{margin:0;height:100%;background:#101014;color:#cfd2d6;
   font:12px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;pointer-events:none}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud">connecting…</div><canvas id="c"></canvas>
<script>
"use strict";
const cv=document.getElementById("c"),hud=document.getElementById("hud");
const gl=cv.getContext("webgl",{antialias:true});
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
 gl.compileShader(o);return o;}
const vs=sh(gl.VERTEX_SHADER,`attribute vec3 p;attribute vec3 c;
 uniform mat4 mvp;uniform float ps;varying vec3 vc;
 void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;vc=c;}`);
const fs=sh(gl.FRAGMENT_SHADER,`precision mediump float;varying vec3 vc;
 void main(){gl_FragColor=vec4(vc,1.0);}`);
const pr=gl.createProgram();gl.attachShader(pr,vs);gl.attachShader(pr,fs);
gl.linkProgram(pr);gl.useProgram(pr);
const aP=gl.getAttribLocation(pr,"p"),aC=gl.getAttribLocation(pr,"c");
const uM=gl.getUniformLocation(pr,"mvp"),uS=gl.getUniformLocation(pr,"ps");
const bufP=gl.createBuffer(),bufC=gl.createBuffer(),bufL=gl.createBuffer();
let nPts=0,nLine=0,version=-1,center=[0,0,0];
let yaw=0.6,pitch=0.4,dist=4.0,panX=0,panY=0;
cv.addEventListener("mousemove",e=>{if(e.buttons===1){yaw+=e.movementX*0.005;
 pitch+=e.movementY*0.005;}else if(e.buttons===2||e.buttons===4){
 panX+=e.movementX*0.002*dist;panY-=e.movementY*0.002*dist;}});
cv.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*0.001);
 e.preventDefault();},{passive:false});
cv.addEventListener("contextmenu",e=>e.preventDefault());
function mat(){const w=cv.width,h=cv.height,f=1.6,n=0.01,fa=200.0;
 const a=w/h;const P=[f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1,
  0,0,2*fa*n/(n-fa),0];
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),
  sp=Math.sin(pitch);
 const eye=[center[0]+dist*cy*cp,center[1]+dist*sp,
  center[2]+dist*sy*cp];
 const tgt=[center[0]+panX,center[1]+panY,center[2]];
 let zx=eye[0]-tgt[0],zy=eye[1]-tgt[1],zz=eye[2]-tgt[2];
 let l=Math.hypot(zx,zy,zz);zx/=l;zy/=l;zz/=l;
 let xx=-zz,xy=0,xz=zx;l=Math.hypot(xx,xy,xz)||1;xx/=l;xz/=l;
 const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 const V=[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0,
  -(xx*eye[0]+xy*eye[1]+xz*eye[2]),
  -(yx*eye[0]+yy*eye[1]+yz*eye[2]),
  -(zx*eye[0]+zy*eye[1]+zz*eye[2]),1];
 const M=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=P[k*4+j]*V[i*4+k];M[i*4+j]=s;}
 return M;}
function draw(){const dpr=window.devicePixelRatio||1;
 const w=cv.clientWidth*dpr,h=cv.clientHeight*dpr;
 if(cv.width!==w||cv.height!==h){cv.width=w;cv.height=h;}
 gl.viewport(0,0,w,h);gl.clearColor(0.063,0.063,0.078,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.enable(gl.DEPTH_TEST);
 const M=mat();gl.uniformMatrix4fv(uM,false,M);
 if(nPts){gl.uniform1f(uS,2.0);
  gl.bindBuffer(gl.ARRAY_BUFFER,bufP);
  gl.enableVertexAttribArray(aP);
  gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,bufC);
  gl.enableVertexAttribArray(aC);
  gl.vertexAttribPointer(aC,3,gl.UNSIGNED_BYTE,true,0,0);
  gl.drawArrays(gl.POINTS,0,nPts);}
 if(nLine){gl.uniform1f(uS,1.0);
  gl.bindBuffer(gl.ARRAY_BUFFER,bufL);
  gl.enableVertexAttribArray(aP);
  gl.vertexAttribPointer(aP,3,gl.FLOAT,false,24,0);
  gl.vertexAttribPointer(aC,3,gl.FLOAT,false,24,12);
  gl.drawArrays(gl.LINES,0,nLine);}
 requestAnimationFrame(draw);}
requestAnimationFrame(draw);
async function poll(){
 try{
  const r=await fetch("/cloud?have="+version);
  if(r.status===200){
   const b=await r.arrayBuffer();const dv=new DataView(b);
   version=dv.getUint32(0,true);
   const n=dv.getUint32(4,true),nc=dv.getUint32(8,true);
   let off=12;
   const xyz=new Float32Array(b,off,n*3);off+=n*12;
   const rgb=new Uint8Array(b,off,n*3);off+=n*3;
   const cams=new Float32Array(b,off,nc*12);
   gl.bindBuffer(gl.ARRAY_BUFFER,bufP);
   gl.bufferData(gl.ARRAY_BUFFER,xyz,gl.DYNAMIC_DRAW);
   gl.bindBuffer(gl.ARRAY_BUFFER,bufC);
   gl.bufferData(gl.ARRAY_BUFFER,rgb,gl.DYNAMIC_DRAW);
   nPts=n;
   const L=[];const col=[0.15,0.65,1.0];
   for(let k=0;k<nc;k++){const o=k*12;
    const C=[cams[o],cams[o+1],cams[o+2]];
    const X=[cams[o+3],cams[o+4],cams[o+5]],
     Y=[cams[o+6],cams[o+7],cams[o+8]],
     Z=[cams[o+9],cams[o+10],cams[o+11]];
    const s=0.06;const pts=[[0,0,0],[-1,-1,1.5],[1,-1,1.5],[1,1,1.5],
     [-1,1,1.5]].map(p=>[C[0]+s*(p[0]*X[0]+p[1]*Y[0]+p[2]*Z[0]),
      C[1]+s*(p[0]*X[1]+p[1]*Y[1]+p[2]*Z[1]),
      C[2]+s*(p[0]*X[2]+p[1]*Y[2]+p[2]*Z[2])]);
    const E=[[0,1],[0,2],[0,3],[0,4],[1,2],[2,3],[3,4],[4,1]];
    for(const[a,c]of E){L.push(...pts[a],...col,...pts[c],...col);}}
   gl.bindBuffer(gl.ARRAY_BUFFER,bufL);
   gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(L),gl.DYNAMIC_DRAW);
   nLine=nc*16;
   if(n){let sx=0,sy=0,sz=0;const st=Math.max(1,(n/2048)|0);let m=0;
    for(let i=0;i<n;i+=st){sx+=xyz[i*3];sy+=xyz[i*3+1];sz+=xyz[i*3+2];
     m++;}
    center=[sx/m,sy/m,sz/m];}
   hud.textContent=`v${version}  ${n.toLocaleString()} pts  ${nc} cams`;
  }
 }catch(e){hud.textContent="disconnected";}
 setTimeout(poll,500);}
poll();
</script></body></html>"""


class LiveViewer:
    """Serve an :class:`IncrementalReconstruction` (or any object with
    ``points`` {frame: (xyz, rgb or None)}, ``cameras`` {frame: world-to-
    camera 7-vector} and ``update()``) on ``host:port``; port 0 picks a
    free one (``viewer.port`` has the result)."""

    def __init__(self, recon, port=0, host="127.0.0.1"):
        self.recon = recon
        self._lock = threading.Lock()
        self._version = 0
        self._blob = self._pack()
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, status, ctype=None, body=b""):
                self.send_response(status)
                if ctype:
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/cloud":
                    have = -1
                    for item in query.split("&"):
                        if item.startswith("have="):
                            try:
                                have = int(item[5:])
                            except ValueError:
                                pass
                    with viewer._lock:
                        ver, blob = viewer._version, viewer._blob
                    if have == ver:
                        self._send(304)
                    else:
                        self._send(200, "application/octet-stream", blob)
                elif path == "/":
                    self._send(200, "text/html; charset=utf-8",
                               _PAGE.encode())
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _pack(self) -> bytes:
        """The binary snapshot of the reconstruction (module docstring)."""
        pts_l, col_l, cams = [], [], []
        r = self.recon
        for f in sorted(r.points):
            p, c = r.points[f]
            pts_l.append(np.asarray(p, np.float32).reshape(-1, 3))
            if c is None:
                col_l.append(np.full((len(p), 3), 200, np.uint8))
            else:
                c = np.asarray(c)
                if c.dtype != np.uint8:
                    scale = 255.0 if (c.size and c.max() <= 1.0) else 1.0
                    c = np.clip(c * scale, 0, 255).astype(np.uint8)
                col_l.append(c.reshape(-1, 3))
        frames = sorted(r.cameras)
        if frames:
            w2c = torch.from_numpy(np.stack(
                [np.asarray(r.cameras[f], np.float32) for f in frames]))
            c2w = lie.se3_inv(w2c)
            R = lie.so3_matrix(c2w[:, 3:])
            cams = torch.cat([c2w[:, :3], R[:, :, 0], R[:, :, 1],
                              R[:, :, 2]], -1).numpy()
        pts = np.concatenate(pts_l) if pts_l else np.zeros((0, 3), np.float32)
        cols = np.concatenate(col_l) if col_l else np.zeros((0, 3), np.uint8)
        cam = np.asarray(cams, np.float32).reshape(-1, 12)
        head = struct.pack("<III", self._version, len(pts), len(cam))
        return (head + pts.astype("<f4").tobytes() + cols.tobytes()
                + cam.astype("<f4").tobytes())

    def refresh(self) -> int:
        """Consume ``video.dirty`` and publish a new snapshot if a frame
        changed.  Returns the number of frames refreshed."""
        n = self.recon.update()
        if n:
            with self._lock:
                self._version += 1
                self._blob = self._pack()
        return n

    @property
    def version(self) -> int:
        return self._version

    @property
    def url(self) -> str:
        return f"http://{self._server.server_address[0]}:{self.port}/"

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def free_port() -> int:
    """A TCP port of 127.0.0.1 free at the time of the call."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p

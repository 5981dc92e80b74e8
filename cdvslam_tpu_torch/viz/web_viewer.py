"""Interactive browser-based 3D viewer (port of
``cdvslam_tpu.viz.web_viewer``: the same page, the same ``state.json``
keys and the same hooks).

Stand-in for the reference's Open3D window (reference:
cdvslam/o3dviewer.py:63-457): the reference runs an O3D process with a
shared-memory state loop; here a background HTTP thread serves a
three.js page (orbit/pan/zoom camera, colored patch point cloud, camera
trajectory + per-keyframe frustums, follow mode, point-size keys,
weight-threshold filtering, img/seg color modes, camera-image pane,
screenshots) and a JSON state endpoint the page polls. Dependency-free
on the Python side (stdlib http.server; three.js loads from CDN in the
browser), works over SSH port-forwarding, and shares the SnapshotViewer
hook surface (update_image / add_delta / join).

Feature map vs the reference viewer:
  * live point colors mid-run (colors_dev pulled on the refresh cadence;
    the reference shares a CUDA buffer, o3dviewer.py:153-156)
  * weight filter: per-patch scatter-mean of BA edge weights
    (slam.py:596-605), threshold stages 2^k / 1-2^-k with 'w'/'W'
    (o3dviewer.py:131-151), default 0.125
  * seg color modes 'm': img -> seg -> seg_no_back (o3dviewer.py:158-176)
  * camera actors for ALL keyframes + current-frame image pane
    (o3dviewer.py:303-330, 374)
  * 's' saves a viewer screenshot (o3dviewer.py:180-199, client-side)
"""
from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..lie import se3_inv
from ..lie.quaternion import qmat

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>cdvslam viewer</title>
<style>body{margin:0;overflow:hidden;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px;z-index:2;background:#0008;padding:6px 10px;border-radius:4px}
#campane{position:fixed;right:8px;bottom:8px;z-index:2;max-width:24%;border:1px solid #444;border-radius:3px}
</style></head><body>
<div id="hud">cdvslam — <span id="stat">connecting…</span><br>
keys: <b>f</b> follow · <b>+/-</b> point size · <b>w/W</b> weight thresh ·
<b>m</b> color mode · <b>c</b> cameras · <b>s</b> screenshot<br>
<span id="mode"></span></div>
<img id="campane" alt="">
<script type="importmap">{"imports":{
 "three":"https://cdn.jsdelivr.net/npm/three@0.160.0/build/three.module.js",
 "three/addons/":"https://cdn.jsdelivr.net/npm/three@0.160.0/examples/jsm/"}}
</script>
<script type="module">
import * as THREE from 'three';
import {OrbitControls} from 'three/addons/controls/OrbitControls.js';
const scene=new THREE.Scene();
const cam=new THREE.PerspectiveCamera(60,innerWidth/innerHeight,0.01,1000);
cam.position.set(0,-2,-4);cam.up.set(0,-1,0);
const rdr=new THREE.WebGLRenderer({antialias:true,preserveDrawingBuffer:true});
rdr.setSize(innerWidth,innerHeight);document.body.appendChild(rdr.domElement);
const ctl=new OrbitControls(cam,rdr.domElement);
let psize=0.02,follow=false,wstage=-3,mode=0,showcams=true;
const MODES=['img','seg','seg_no_back'];
const pmat=new THREE.PointsMaterial({size:psize,vertexColors:true});
let pts=new THREE.Points(new THREE.BufferGeometry(),pmat);scene.add(pts);
const tmat=new THREE.LineBasicMaterial({color:0x4488ff});
let traj=new THREE.Line(new THREE.BufferGeometry(),tmat);scene.add(traj);
const fmat=new THREE.LineBasicMaterial({color:0xff4444});
let frus=new THREE.LineSegments(new THREE.BufferGeometry(),fmat);scene.add(frus);
const kmat=new THREE.LineBasicMaterial({color:0x8888dd});
let kfrus=new THREE.LineSegments(new THREE.BufferGeometry(),kmat);scene.add(kfrus);
let S=null;
function wthresh(){return wstage==0?0.5:(wstage<0?2**wstage:1-2**(-wstage));}
function rebuild(){
 if(!S)return;
 const thr=wthresh(),n=S.points.length/3;
 const P=[],C=[];
 const cols=(mode==0||!S.segcolors.length)?S.colors:S.segcolors;
 for(let i=0;i<n;i++){
  if(S.weights.length&&S.weights[i]<=thr)continue;
  if(mode==2&&S.segcolors.length&&S.segclass[i]==0)continue;
  P.push(S.points[3*i],S.points[3*i+1],S.points[3*i+2]);
  C.push(cols[3*i],cols[3*i+1],cols[3*i+2]);}
 const g=new THREE.BufferGeometry();
 g.setAttribute('position',new THREE.Float32BufferAttribute(P,3));
 g.setAttribute('color',new THREE.Float32BufferAttribute(C,3));
 pts.geometry.dispose();pts.geometry=g;
 document.getElementById('mode').textContent=
  `mode ${MODES[mode]} · wthr ${thr.toFixed(3)} · ${P.length/3}/${n} pts`;
}
addEventListener('resize',()=>{cam.aspect=innerWidth/innerHeight;
 cam.updateProjectionMatrix();rdr.setSize(innerWidth,innerHeight);});
addEventListener('keydown',e=>{
 if(e.key=='f')follow=!follow;
 if(e.key=='+'||e.key=='=')pmat.size=psize*=1.3;
 if(e.key=='-')pmat.size=psize/=1.3;
 if(e.key=='w'){wstage+=1;rebuild();}
 if(e.key=='W'){wstage-=1;rebuild();}
 if(e.key=='m'){mode=(mode+1)%3;rebuild();}
 if(e.key=='c'){showcams=!showcams;kfrus.visible=showcams;}
 if(e.key=='s'){const a=document.createElement('a');
  a.download='cdvslam_'+Date.now()+'.png';
  a.href=rdr.domElement.toDataURL('image/png');a.click();}});
async function poll(){
 try{
  const s=await (await fetch('state.json')).json();
  S=s;
  document.getElementById('stat').textContent=
   `kf ${s.n} · ${s.points.length/3} pts`;
  rebuild();
  const tg=new THREE.BufferGeometry();
  tg.setAttribute('position',new THREE.Float32BufferAttribute(s.traj,3));
  traj.geometry.dispose();traj.geometry=tg;
  const fg=new THREE.BufferGeometry();
  fg.setAttribute('position',new THREE.Float32BufferAttribute(s.frustum,3));
  frus.geometry.dispose();frus.geometry=fg;
  const kg=new THREE.BufferGeometry();
  kg.setAttribute('position',new THREE.Float32BufferAttribute(s.kf_frustums,3));
  kfrus.geometry.dispose();kfrus.geometry=kg;
  if(s.image)document.getElementById('campane').src='data:image/jpeg;base64,'+s.image;
  if(follow&&s.traj.length>=3){
   const k=s.traj.length-3;
   ctl.target.set(s.traj[k],s.traj[k+1],s.traj[k+2]);}
 }catch(e){document.getElementById('stat').textContent='… '+e;}
 setTimeout(poll,500);}
poll();
function loop(){requestAnimationFrame(loop);ctl.update();rdr.render(scene,cam);}
loop();
</script></body></html>"""


def _frustum_segments(pose_inv, scale=0.15):
    """Line-segment vertices of a camera frustum from a c2w (7,) pose."""
    R = qmat(torch.as_tensor(np.asarray(pose_inv[3:7], np.float32))[None])[0].numpy()
    C = pose_inv[:3]
    c = [np.array([0, 0, 0.0]),
         np.array([-1, -0.75, 1.5]), np.array([1, -0.75, 1.5]),
         np.array([1, 0.75, 1.5]), np.array([-1, 0.75, 1.5])]
    w = [C + scale * (R @ p) for p in c]
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    out = []
    for a, b in edges:
        out.extend(w[a].tolist())
        out.extend(w[b].tolist())
    return out


def _frustums_all(inv, scale=0.08):
    """Frustum segments for every keyframe pose (vectorized over rows)."""
    R = qmat(torch.as_tensor(np.asarray(inv[:, 3:7], np.float32))).numpy()   # (n, 3, 3)
    C = inv[:, :3]                                            # (n, 3)
    c = np.array([[0, 0, 0], [-1, -0.75, 1.5], [1, -0.75, 1.5],
                  [1, 0.75, 1.5], [-1, 0.75, 1.5]], np.float32)
    w = C[:, None, :] + scale * np.einsum("nij,kj->nki", R, c)  # (n, 5, 3)
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    seg = np.stack([w[:, [a for a, _ in edges]],
                    w[:, [b for _, b in edges]]], axis=2)      # (n, 8, 2, 3)
    return np.round(seg, 4).reshape(-1).tolist()


class WebViewer:
    """Interactive viewer: same hook surface as SnapshotViewer, rendered
    live in a browser at http://localhost:<port>/."""

    def __init__(self, slam, port=8642, every=5, max_points=120000,
                 host="127.0.0.1"):
        """``port`` 0 takes a free port (``self.port`` tells which)."""
        self.slam = slam
        self.every = every
        self.max_points = max_points
        self.count = 0
        self._state = {"n": 0, "points": [], "colors": [], "traj": [],
                       "frustum": [], "kf_frustums": [], "weights": [],
                       "segcolors": [], "segclass": [], "image": ""}
        self._lock = threading.Lock()
        self._last_image = None
        # persistent per-patch viewer weights (reference pg.weight_,
        # patchgraph.py:50: init ones, only touched patches update)
        self._pweight = np.ones(slam.N * slam.M, np.float32)
        viewer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/state.json"):
                    with viewer._lock:
                        body = json.dumps(viewer._state).encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        # loopback by default (the viewer is unauthenticated); pass
        # host="0.0.0.0" explicitly to expose it, or use SSH forwarding
        self.server = ThreadingHTTPServer((host, port), H)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        print(f"[viewer] interactive viewer at http://localhost:{self.port}/")

    # -- runtime hooks (same surface as SnapshotViewer) -----------------
    def update_image(self, image, *args, **kwargs):
        self.count += 1
        self._last_image = image
        if self.count % self.every == 0:
            self.refresh()

    def add_delta(self, *args, **kwargs):
        pass

    def _encode_image(self):
        """Downscaled JPEG of the latest camera frame (the reference's
        image pane, o3dviewer.py:374). The JAX viewer sends no image when
        cv2 is missing or the encoder fails; the port raises."""
        import cv2

        if self._last_image is None:
            return ""
        img = np.ascontiguousarray(np.asarray(self._last_image)[::2, ::2, ::-1])
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
        if not ok:
            raise RuntimeError("cv2 cannot encode the viewer's camera image")
        return base64.b64encode(buf.tobytes()).decode()

    @torch.no_grad()
    def refresh(self):
        """Pull the poses, points, colours, the last update's edge weights
        and the seg rows from the device (a host sync; it runs every
        ``every`` kept frames and in ``join()``)."""
        slam = self.slam
        pg = slam.pg
        n = pg.n
        if n < 2:
            return
        inv = se3_inv(pg.poses_[:n]).cpu().numpy()
        centers = inv[:, :3]
        m = pg.m
        pts = slam.points()[:m]
        # LIVE colors: pull the device color buffer (same conversion the
        # runtime applies at terminate; reference shares a CUDA buffer)
        cdev = pg.colors_dev[: (m + slam.M - 1) // slam.M].cpu().numpy()
        clr = np.clip((cdev.reshape(-1, 3)[:, [2, 1, 0]] + 0.5)
                      * (255.0 / 2), 0, 255)[: len(pts)]
        # per-patch BA weights: scatter-mean of the last update's edge
        # weights over kk (reference slam.py:596-605); pg.weight is None
        # while the edges differ from the last update's
        if pg.weight is not None:
            ew = pg.weight.mean(-1).float().cpu().numpy()
            kk = pg.kk
            s = np.zeros(self._pweight.shape[0], np.float64)
            c = np.zeros(self._pweight.shape[0], np.int64)
            np.add.at(s, kk, ew)
            np.add.at(c, kk, 1)
            touched = c > 0
            self._pweight[touched] = (s[touched] / c[touched]).astype(np.float32)
        wts = self._pweight[: len(pts)]
        # seg colors (reference o3dviewer modes 'seg'/'seg_no_back')
        segcolors = []
        segclass = []
        if slam.seg_head is not None:
            from ..models.datamaps import seg_colormap
            segc = pg.seg_[: (m + slam.M - 1) // slam.M].cpu().numpy()
            segc = segc.reshape(-1)[: len(pts)].astype(np.int64)
            cmap = seg_colormap(150)
            segcolors = (cmap[np.clip(segc, 0, len(cmap) - 1)] / 255.0)
            segclass = segc
        valid = np.isfinite(pts).all(axis=1) & (np.abs(pts) < 1e3).all(axis=1)
        pts, clr, wts = pts[valid], clr[valid], wts[valid]
        if len(segcolors):
            segcolors, segclass = segcolors[valid], segclass[valid]
        if len(pts) > self.max_points:
            sel = np.linspace(0, len(pts) - 1, self.max_points).astype(int)
            pts, clr, wts = pts[sel], clr[sel], wts[sel]
            if len(segcolors):
                segcolors, segclass = segcolors[sel], segclass[sel]
        state = {
            "n": int(n),
            "points": np.round(pts, 4).reshape(-1).tolist(),
            "colors": (clr.astype(np.float32) / 255.0).round(3).reshape(-1).tolist(),
            "traj": np.round(centers, 4).reshape(-1).tolist(),
            "frustum": _frustum_segments(inv[-1]),
            "kf_frustums": _frustums_all(inv),
            "weights": np.round(wts, 4).tolist(),
            "segcolors": (np.round(segcolors, 3).reshape(-1).tolist()
                          if len(segcolors) else []),
            "segclass": (np.asarray(segclass).tolist()
                         if len(segclass) else []),
            "image": self._encode_image(),
        }
        with self._lock:
            self._state = state

    def join(self):
        self.refresh()
        self.server.shutdown()
        self.server.server_close()

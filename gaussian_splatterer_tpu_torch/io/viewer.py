"""Shareable interactive splat viewer: one self-contained HTML file
(counterpart of gaussian_splatterer_tpu.io.viewer; numpy only).

The reference's live splat-preview panel re-renders every idle tick
(src/ui/UiPanelViewOutput.cpp:52-70).  Its headless stand-in: the model
exported to a single HTML file with the splat data embedded (base64
float32) and a WebGL2 renderer with no dependency: EWA projection in the
vertex shader (the math of ops/transforms.py), Gaussian falloff in the
fragment shader, back-to-front compositing by a JS depth sort, an
orbit/zoom mouse camera.  It works offline and is shared as a file.

Colour is the SH DC term plus degree-1 view dependence evaluated per frame
in JS; bands >= 2 are baked view-independent at export time (full SH
stays in training and in .gobj/.ply).  The file is byte-equal to the JAX
package's for the same model and title.
"""

from __future__ import annotations

import base64
import json

import numpy as np

from gaussian_splatterer_tpu_torch.models.splats import SplatModel, SplatModelHost
from gaussian_splatterer_tpu_torch.ops.transforms import SH_C0, SH_C1, sh_eval_linear

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>gsplat-tpu viewer</title>
<style>
  html,body{margin:0;height:100%;overflow:hidden;background:#111;color:#ddd;
    font:12px system-ui}
  #c{width:100%;height:100%;display:block}
  #hud{position:fixed;top:8px;left:8px;background:rgba(0,0,0,.5);
    padding:6px 10px;border-radius:6px;pointer-events:none}
</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<script>
"use strict";
const META = __META__;
const B64 = "__DATA__";
const raw = Uint8Array.from(atob(B64), ch => ch.charCodeAt(0));
const F = new Float32Array(raw.buffer);
const N = META.count;
// packed per splat: pos3, scale3, quat4, rgb3(dc), sh1 9 (deg-1 * 3ch), a1
const STRIDE = 23;

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl2", {antialias:false});
if (!gl) document.getElementById("hud").textContent = "WebGL2 required";

const VS = `#version 300 es
layout(location=0) in vec2 corner;     // quad corner, 3-sigma units
layout(location=1) in vec3 pos;
layout(location=2) in vec3 scale;
layout(location=3) in vec4 quat;       // [w,x,y,z]
layout(location=4) in vec3 rgb;
layout(location=5) in vec3 sh1x;       // per-channel deg-1 coeffs
layout(location=6) in vec3 sh1y;
layout(location=7) in vec3 sh1z;
layout(location=8) in float opacity;
uniform mat4 uView;                    // world -> view
uniform mat4 uProj;
uniform vec2 uFocal;                   // pixels
uniform vec2 uViewport;
uniform vec3 uEye;
out vec2 vXY;                          // position in sigma units
out vec4 vColA;
void main(){
  vec4 vc = uView * vec4(pos,1.0);
  // RH view space: the camera looks down -z, visible points have vc.z < 0
  if (vc.z > -0.2) { gl_Position = vec4(0,0,2,1); return; }
  float tz = -vc.z;                    // positive view depth
  // cov3d = R S^2 R^T
  float w=quat.x,x=quat.y,y=quat.z,z=quat.w;
  float qn = inversesqrt(max(w*w+x*x+y*y+z*z,1e-12));
  w*=qn;x*=qn;y*=qn;z*=qn;
  mat3 R = mat3(
    1.-2.*(y*y+z*z), 2.*(x*y+w*z),   2.*(x*z-w*y),
    2.*(x*y-w*z),    1.-2.*(x*x+z*z),2.*(y*z+w*x),
    2.*(x*z+w*y),    2.*(y*z-w*x),   1.-2.*(x*x+y*y));
  mat3 S2 = mat3(scale.x*scale.x,0,0, 0,scale.y*scale.y,0, 0,0,scale.z*scale.z);
  mat3 V = R*S2*transpose(R);
  // EWA: J W V W^T J^T (2x2 upper block), W = view rotation
  mat3 W3 = mat3(uView);
  float iz = 1.0/tz;
  // d(x_img)/d(vc.z) = +f*vc.x*iz^2 here: x_img = f*vc.x/tz with
  // tz = -vc.z (the INRIA formula's minus sign belongs to its +z-forward
  // convention and must flip with ours)
  mat3 J = mat3(uFocal.x*iz,0,0, 0,uFocal.y*iz,0,
                uFocal.x*vc.x*iz*iz, uFocal.y*vc.y*iz*iz, 0);
  mat3 T = J*W3;
  mat3 C = T*V*transpose(T);
  float cxx=C[0][0]+0.3, cxy=C[1][0], cyy=C[1][1]+0.3;
  float det = cxx*cyy-cxy*cxy;
  if (det<=0.0){ gl_Position=vec4(0,0,2,1); return; }
  // principal axes of the 2x2 covariance for the quad basis
  float mid=0.5*(cxx+cyy);
  float d=sqrt(max(mid*mid-det,1e-9));
  float l1=mid+d, l2=max(mid-d,1e-9);
  vec2 e1 = normalize(vec2(cxy, l1-cxx));
  if (abs(cxy)<1e-9) e1 = (cxx>=cyy)?vec2(1,0):vec2(0,1);
  vec2 e2 = vec2(-e1.y,e1.x);
  vec2 px = corner.x*e1*sqrt(l1)*3.0 + corner.y*e2*sqrt(l2)*3.0; // 3 sigma
  // (2-sigma quads leave a visible elliptical clip edge: border alpha
  // = opacity*exp(-2) ~ 0.135, far above the 1/255 discard)
  vec4 clip = uProj * vc;
  vec2 ndc = clip.xy/clip.w + px/(0.5*uViewport);
  gl_Position = vec4(ndc*clip.w, clip.z, clip.w);
  vXY = corner*3.0;
  // view-dependent color: dc + degree-1 SH (INRIA band-1 signs)
  vec3 dir = normalize(pos - uEye);
  vec3 col = rgb + __SHC1__*(-dir.y*sh1x + dir.z*sh1y - dir.x*sh1z);
  vColA = vec4(max(col,0.0), opacity);
}`;

const FS = `#version 300 es
precision highp float;
in vec2 vXY; in vec4 vColA; out vec4 o;
void main(){
  float p = -0.5*dot(vXY,vXY);
  float a = vColA.a*exp(p);
  if (a < 1.0/255.0) discard;
  o = vec4(vColA.rgb*a, a);   // premultiplied, blended back-to-front
}`;

function sh(type, src){const s=gl.createShader(type);gl.shaderSource(s,src);
  gl.compileShader(s);
  if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog);
if(!gl.getProgramParameter(prog,gl.LINK_STATUS))
  throw gl.getProgramInfoLog(prog);
gl.useProgram(prog);

// static quad corners + per-splat instance buffer (re-uploaded on sort)
const quad = new Float32Array([-1,-1, 1,-1, -1,1, 1,1]);
const qb = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, qb);
gl.bufferData(gl.ARRAY_BUFFER, quad, gl.STATIC_DRAW);
gl.enableVertexAttribArray(0);
gl.vertexAttribPointer(0,2,gl.FLOAT,false,0,0);

const ib = gl.createBuffer();
const inst = new Float32Array(N*STRIDE);
const order = new Uint32Array(N);
const depths = new Float32Array(N);
function setupInstanced(){
  gl.bindBuffer(gl.ARRAY_BUFFER, ib);
  const B = STRIDE*4;
  const offs = [[1,3,0],[2,3,12],[3,4,24],[4,3,40],[5,3,52],[6,3,64],
                [7,3,76],[8,1,88]];
  for (const [loc,size,off] of offs){
    gl.enableVertexAttribArray(loc);
    gl.vertexAttribPointer(loc,size,gl.FLOAT,false,B,off);
    gl.vertexAttribDivisor(loc,1);
  }
}
setupInstanced();

gl.enable(gl.BLEND);
gl.blendFunc(gl.ONE, gl.ONE_MINUS_SRC_ALPHA);
gl.disable(gl.DEPTH_TEST);

// orbit camera
let theta=0.6, phi=0.4, dist=META.suggested_distance, target=META.center;
canvas.addEventListener("mousedown", e=>{
  const sx=e.clientX, sy=e.clientY, t0=theta, p0=phi;
  const move=ev=>{theta=t0+(ev.clientX-sx)*0.005; phi=Math.max(-1.5,
    Math.min(1.5,p0+(ev.clientY-sy)*0.005));};
  const up=()=>{removeEventListener("mousemove",move);
    removeEventListener("mouseup",up);};
  addEventListener("mousemove",move); addEventListener("mouseup",up);
});
canvas.addEventListener("wheel", e=>{dist*=Math.exp(e.deltaY*0.001);
  e.preventDefault();}, {passive:false});

function mat4LookAt(eye,c,up){
  const z=norm3(sub3(eye,c)), x=norm3(cross3(up,z)), y=cross3(z,x);
  return [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
    -dot3(x,eye),-dot3(y,eye),-dot3(z,eye),1];
}
function mat4Persp(fy,ar,n,f){const t=1/Math.tan(fy/2);
  return [t/ar,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1, 0,0,2*f*n/(n-f),0];}
const sub3=(a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]];
const dot3=(a,b)=>a[0]*b[0]+a[1]*b[1]+a[2]*b[2];
const cross3=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
  a[0]*b[1]-a[1]*b[0]];
const norm3=a=>{const l=Math.hypot(...a);return [a[0]/l,a[1]/l,a[2]/l];};

function frame(){
  const w=canvas.clientWidth, h=canvas.clientHeight;
  if (canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
  gl.viewport(0,0,w,h);
  gl.clearColor(0,0,0,1); gl.clear(gl.COLOR_BUFFER_BIT);
  const eye=[target[0]+dist*Math.cos(phi)*Math.sin(theta),
             target[1]+dist*Math.sin(phi),
             target[2]+dist*Math.cos(phi)*Math.cos(theta)];
  const view=mat4LookAt(eye,target,[0,1,0]);
  const fovy=Math.PI/4;
  const proj=mat4Persp(fovy,w/h,0.1,100);
  // depth sort back-to-front (view z per splat)
  for(let i=0;i<N;i++){
    const o=i*STRIDE;
    depths[i]=view[2]*F[o]+view[6]*F[o+1]+view[10]*F[o+2];
    order[i]=i;
  }
  // camera looks down -z in view space: farther = more negative view z,
  // so ascending sort draws back-to-front
  order.sort((a,b)=>depths[a]-depths[b]);
  for(let k=0;k<N;k++){
    const s=order[k]*STRIDE, d=k*STRIDE;
    for(let j=0;j<STRIDE;j++) inst[d+j]=F[s+j];
  }
  gl.bindBuffer(gl.ARRAY_BUFFER, ib);
  gl.bufferData(gl.ARRAY_BUFFER, inst, gl.DYNAMIC_DRAW);
  gl.uniformMatrix4fv(gl.getUniformLocation(prog,"uView"),false,view);
  gl.uniformMatrix4fv(gl.getUniformLocation(prog,"uProj"),false,proj);
  const fl=0.5*h/Math.tan(fovy/2);
  gl.uniform2f(gl.getUniformLocation(prog,"uFocal"),fl*1.0,fl);
  gl.uniform2f(gl.getUniformLocation(prog,"uViewport"),w,h);
  gl.uniform3f(gl.getUniformLocation(prog,"uEye"),eye[0],eye[1],eye[2]);
  gl.drawArraysInstanced(gl.TRIANGLE_STRIP,0,4,N);
  document.getElementById("hud").textContent =
    `${N} splats — drag to orbit, wheel to zoom`;
  requestAnimationFrame(frame);
}
requestAnimationFrame(frame);
</script></body></html>
"""


def pack_viewer_arrays(host: SplatModelHost) -> np.ndarray:
    """(N, 23) float32: pos3, scale3, quat4, rgb_dc3, sh1 3x3, opacity.

    Degree-1 SH stays view-dependent in the shader; bands >= 2 are baked
    into the DC colour at the nominal forward direction (0, 0, -1)."""
    n = host.count
    rgb = SH_C0 * host.shs[:n, 0] + 0.5  # DC colour (clamped in the shader)
    if host.sh_coeffs > 4:
        d0 = np.broadcast_to(np.asarray([0.0, 0.0, -1.0], np.float32), (n, 3))
        shs2 = np.array(host.shs[:n])
        shs2[:, :4] = 0.0  # bands 0-1 are evaluated exactly; bake only >= 2
        rgb = rgb + np.asarray(sh_eval_linear(shs2, d0, host.sh_degree))
    if host.sh_coeffs >= 4:
        sh1 = host.shs[:n, 1:4]  # (N, 3, 3): [y, z, x] bands per channel
    else:
        sh1 = np.zeros((n, 3, 3), np.float32)
    packed = np.concatenate(
        [
            host.means[:n],
            host.scales[:n],
            host.rotations[:n],
            rgb.astype(np.float32),
            sh1.reshape(n, 9).astype(np.float32),
            host.opacities[:n, None],
        ],
        axis=1,
    ).astype(np.float32)
    assert packed.shape[1] == 23
    return packed


def export_viewer_html(model, path: str, title: str = "gsplat-tpu") -> None:
    """Write a self-contained interactive HTML viewer of ``model`` (a
    SplatModel on any device, or a SplatModelHost)."""
    host = model.to_host() if isinstance(model, SplatModel) else model
    packed = pack_viewer_arrays(host)
    data_b64 = base64.b64encode(packed.tobytes()).decode()
    center = packed[:, 0:3].mean(axis=0) if len(packed) else np.zeros(3)
    spread = float(np.abs(packed[:, 0:3] - center).max()) if len(packed) else 1.0
    meta = {
        "count": int(host.count),
        "center": [float(c) for c in center],
        "sh_degree": int(host.sh_degree),
        "suggested_distance": max(2.0, 3.0 * spread),
        "title": title,
    }
    html = (
        _TEMPLATE
        .replace("__META__", json.dumps(meta))
        .replace("__DATA__", data_b64)
        .replace("__SHC1__", repr(float(SH_C1)))
    )
    with open(path, "w") as fh:
        fh.write(html)

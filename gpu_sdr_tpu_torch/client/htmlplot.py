"""Self-contained interactive HTML plotting backend (the port's copy of
gpu_sdr_tpu/client/htmlplot.py: the same page, byte for byte, for the
same data).

The reference offers a plotly backend next to matplotlib (plot_VNA,
pyUSRP/USRP_VNA.py:807-1100; styling via style_plotly_figure,
pyUSRP/USRP_plotting.py:63-71).  This environment ships no plotly, so the
interactive backend is implemented from scratch: figures are written as a
single HTML file with the trace data embedded as JSON and a small inline
SVG renderer providing wheel zoom, drag pan, hover readout and
legend-click trace toggling — no external assets, works offline.

Usage:
    fig = Figure(title="...")
    p = fig.panel(ylabel="S21 [dB]")
    p.line(freq, mag, name="sweep 0", color="#1f77b4")
    fig.panel(ylabel="phase [rad]").line(freq, ph, name="phase")
    fig.write_html("out.html")
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np


class Panel:
    def __init__(self, ylabel: str = "", xlabel: str = "",
                 xlog: bool = False, ylog: bool = False):
        self.ylabel = ylabel
        self.xlabel = xlabel
        self.xlog = xlog
        self.ylog = ylog
        self.traces: List[dict] = []
        self.images: List[dict] = []

    def line(self, x, y, name: str = "", color: Optional[str] = None,
             dash: bool = False, markers: bool = False) -> "Panel":
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        m = np.isfinite(x) & np.isfinite(y)
        self.traces.append({
            "x": [round(float(v), 9) for v in x[m]],
            "y": [round(float(v), 9) for v in y[m]],
            "name": name, "color": color, "dash": bool(dash),
            "markers": bool(markers)})
        return self

    def image(self, z2d, extent, cmap: str = "viridis",
              label: str = "") -> "Panel":
        """Embed a heatmap (rendered once to a data-URI PNG; axes stay
        interactive around it)."""
        import base64
        import io
        from .plotting import _matplotlib
        matplotlib = _matplotlib()
        import matplotlib.cm as cm
        z = np.asarray(z2d, dtype=float)
        zmin, zmax = np.nanmin(z), np.nanmax(z)
        norm = (z - zmin) / (zmax - zmin if zmax > zmin else 1.0)
        rgba = (getattr(cm, cmap)(norm) * 255).astype(np.uint8)
        from matplotlib.image import imsave
        buf = io.BytesIO()
        imsave(buf, rgba, format="png", origin="lower")
        uri = "data:image/png;base64," + \
            base64.b64encode(buf.getvalue()).decode()
        self.images.append({"uri": uri, "extent": list(map(float, extent)),
                            "label": label,
                            "zmin": float(zmin), "zmax": float(zmax)})
        return self


class Figure:
    def __init__(self, title: str = ""):
        self.title = title
        self.panels: List[Panel] = []

    def panel(self, ylabel: str = "", xlabel: str = "", xlog: bool = False,
              ylog: bool = False) -> Panel:
        p = Panel(ylabel=ylabel, xlabel=xlabel, xlog=xlog, ylog=ylog)
        self.panels.append(p)
        return p

    def write_html(self, path: str, auto_open: bool = False) -> str:
        payload = {
            "title": self.title,
            "panels": [{
                "ylabel": p.ylabel, "xlabel": p.xlabel,
                "xlog": p.xlog, "ylog": p.ylog,
                "traces": p.traces, "images": p.images,
            } for p in self.panels],
        }
        # escape '</' so strings (names/titles) cannot terminate the
        # <script> element mid-JSON
        html = _TEMPLATE.replace(
            "__DATA__", json.dumps(payload).replace("</", "<\\/"))
        with open(path, "w") as f:
            f.write(html)
        if auto_open:  # pragma: no cover - headless CI has no browser
            import webbrowser
            webbrowser.open("file://" + os.path.abspath(path))
        return path


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>gpu_sdr_tpu plot</title>
<style>
body{font-family:sans-serif;background:#fff;margin:12px}
.panel{margin-bottom:10px}
svg{border:1px solid #ccc;background:rgba(0,0,0,0)}
.legend span{cursor:pointer;margin-right:12px;user-select:none}
.legend .off{opacity:0.3;text-decoration:line-through}
#tip{position:absolute;background:#222;color:#fff;padding:2px 6px;
     border-radius:3px;font-size:11px;pointer-events:none;display:none}
h2{font-size:16px}
</style></head><body>
<h2 id="title"></h2><div id="root"></div><div id="tip"></div>
<script>
const DATA = __DATA__;
const W=900, H=300, ML=70, MR=15, MT=10, MB=40;
document.getElementById('title').textContent = DATA.title;
const palette=['#1f77b4','#d62728','#2ca02c','#9467bd','#ff7f0e',
               '#8c564b','#e377c2','#17becf'];
function fmt(v){ if(!isFinite(v)) return '';
  const a=Math.abs(v); if(a!==0&&(a<1e-3||a>=1e6)) return v.toExponential(2);
  return String(Math.round(v*1e6)/1e6); }
DATA.panels.forEach((p,pi)=>{
  const div=document.createElement('div'); div.className='panel';
  const svgNS='http://www.w3.org/2000/svg';
  const svg=document.createElementNS(svgNS,'svg');
  svg.setAttribute('width',W); svg.setAttribute('height',H);
  div.appendChild(svg);
  const legend=document.createElement('div'); legend.className='legend';
  div.appendChild(legend);
  document.getElementById('root').appendChild(div);
  const tx=v=>p.xlog?Math.log10(Math.max(v,1e-300)):v;
  const ty=v=>p.ylog?Math.log10(Math.max(v,1e-300)):v;
  let x0=1/0,x1=-1/0,y0=1/0,y1=-1/0;
  // log axes: nonpositive samples are excluded from the BOUNDS (a
  // single zero would autoscale to ~300 decades and flatten the plot)
  p.traces.forEach(t=>{t.x.forEach(v=>{if(p.xlog&&v<=0)return;
      const u=tx(v); if(u<x0)x0=u; if(u>x1)x1=u;});
    t.y.forEach(v=>{if(p.ylog&&v<=0)return;
      const u=ty(v); if(u<y0)y0=u; if(u>y1)y1=u;});});
  // image extents join the bounds in TRANSFORMED space (sx/sy apply tx
  // to them at render time)
  p.images.forEach(im=>{const e=im.extent;
    x0=Math.min(x0,tx(e[0])); x1=Math.max(x1,tx(e[1]));
    y0=Math.min(y0,ty(e[2])); y1=Math.max(y1,ty(e[3]));});
  if(!isFinite(x0)){x0=0;x1=1;} if(!isFinite(y0)){y0=0;y1=1;}
  if(x0===x1){x1=x0+1;} if(y0===y1){y1=y0+1;}
  const pad=(y1-y0)*0.05; y0-=pad; y1+=pad;
  let vx0=x0,vx1=x1,vy0=y0,vy1=y1;       // current view
  const sx=v=>ML+(tx(v)-vx0)/(vx1-vx0)*(W-ML-MR);
  const sy=v=>H-MB-(ty(v)-vy0)/(vy1-vy0)*(H-MT-MB);
  const hidden=new Set();
  function render(){
    while(svg.firstChild) svg.removeChild(svg.firstChild);
    // clip
    const defs=document.createElementNS(svgNS,'defs');
    defs.innerHTML='<clipPath id="c'+pi+'"><rect x="'+ML+'" y="'+MT+
      '" width="'+(W-ML-MR)+'" height="'+(H-MT-MB)+'"/></clipPath>';
    svg.appendChild(defs);
    // images
    p.images.forEach(im=>{
      const e=im.extent;
      const img=document.createElementNS(svgNS,'image');
      img.setAttribute('href',im.uri);
      const xA=sx(e[0]), xB=sx(e[1]);
      const yA=sy(e[3]), yB=sy(e[2]);
      img.setAttribute('x',xA); img.setAttribute('y',yA);
      img.setAttribute('width',xB-xA); img.setAttribute('height',yB-yA);
      img.setAttribute('preserveAspectRatio','none');
      img.setAttribute('clip-path','url(#c'+pi+')');
      svg.appendChild(img);
    });
    // grid + ticks
    for(let i=0;i<=5;i++){
      const gx=vx0+(vx1-vx0)*i/5, px=ML+(W-ML-MR)*i/5;
      const gy=vy0+(vy1-vy0)*i/5, py=H-MB-(H-MT-MB)*i/5;
      const lv=document.createElementNS(svgNS,'line');
      lv.setAttribute('x1',px);lv.setAttribute('x2',px);
      lv.setAttribute('y1',MT);lv.setAttribute('y2',H-MB);
      lv.setAttribute('stroke','#eee'); svg.appendChild(lv);
      const lh=document.createElementNS(svgNS,'line');
      lh.setAttribute('x1',ML);lh.setAttribute('x2',W-MR);
      lh.setAttribute('y1',py);lh.setAttribute('y2',py);
      lh.setAttribute('stroke','#eee'); svg.appendChild(lh);
      const txl=document.createElementNS(svgNS,'text');
      txl.setAttribute('x',px); txl.setAttribute('y',H-MB+14);
      txl.setAttribute('font-size','10'); txl.setAttribute('text-anchor','middle');
      txl.textContent=fmt(p.xlog?Math.pow(10,gx):gx); svg.appendChild(txl);
      const tyl=document.createElementNS(svgNS,'text');
      tyl.setAttribute('x',ML-5); tyl.setAttribute('y',py+3);
      tyl.setAttribute('font-size','10'); tyl.setAttribute('text-anchor','end');
      tyl.textContent=fmt(p.ylog?Math.pow(10,gy):gy); svg.appendChild(tyl);
    }
    // axis labels
    const xl=document.createElementNS(svgNS,'text');
    xl.setAttribute('x',(ML+W-MR)/2); xl.setAttribute('y',H-6);
    xl.setAttribute('font-size','12'); xl.setAttribute('text-anchor','middle');
    xl.textContent=p.xlabel; svg.appendChild(xl);
    const yl=document.createElementNS(svgNS,'text');
    yl.setAttribute('transform','translate(14,'+(MT+(H-MT-MB)/2)+
      ') rotate(-90)');
    yl.setAttribute('font-size','12'); yl.setAttribute('text-anchor','middle');
    yl.textContent=p.ylabel; svg.appendChild(yl);
    // traces
    p.traces.forEach((t,ti)=>{
      if(hidden.has(ti)) return;
      const col=t.color||palette[ti%palette.length];
      let d='';
      for(let i=0;i<t.x.length;i++){
        d+=(i?'L':'M')+sx(t.x[i]).toFixed(1)+' '+sy(t.y[i]).toFixed(1);
      }
      const path=document.createElementNS(svgNS,'path');
      path.setAttribute('d',d); path.setAttribute('fill','none');
      path.setAttribute('stroke',col);
      if(t.dash) path.setAttribute('stroke-dasharray','5,4');
      path.setAttribute('clip-path','url(#c'+pi+')');
      svg.appendChild(path);
      if(t.markers){
        for(let i=0;i<t.x.length;i++){
          const c=document.createElementNS(svgNS,'circle');
          c.setAttribute('cx',sx(t.x[i])); c.setAttribute('cy',sy(t.y[i]));
          c.setAttribute('r',2.2); c.setAttribute('fill',col);
          c.setAttribute('clip-path','url(#c'+pi+')');
          svg.appendChild(c);
        }
      }
    });
  }
  // legend
  p.traces.forEach((t,ti)=>{
    const s=document.createElement('span');
    s.style.color=t.color||palette[ti%palette.length];
    s.textContent='\\u2014 '+(t.name||('trace '+ti));
    s.onclick=()=>{ if(hidden.has(ti)) hidden.delete(ti);
                    else hidden.add(ti);
                    s.classList.toggle('off'); render(); };
    legend.appendChild(s);
  });
  // svg-relative pointer position (offsetX/Y would be relative to the
  // event TARGET, which can be an embedded image or a trace element)
  const mpos=ev=>{const r=svg.getBoundingClientRect();
    return [ev.clientX-r.left, ev.clientY-r.top];};
  // wheel zoom (x around cursor; shift = y)
  svg.addEventListener('wheel',ev=>{
    ev.preventDefault();
    const k=ev.deltaY>0?1.2:1/1.2;
    const m=mpos(ev);
    if(ev.shiftKey){
      const f=vy0+(vy1-vy0)*(1-(m[1]-MT)/(H-MT-MB));
      vy0=f+(vy0-f)*k; vy1=f+(vy1-f)*k;
    } else {
      const f=vx0+(vx1-vx0)*(m[0]-ML)/(W-ML-MR);
      vx0=f+(vx0-f)*k; vx1=f+(vx1-f)*k;
    }
    render();
  });
  // drag pan
  let drag=null;
  svg.addEventListener('mousedown',ev=>{const m=mpos(ev);
    drag=[m[0],m[1],vx0,vx1,vy0,vy1];});
  window.addEventListener('mouseup',()=>{drag=null;});
  svg.addEventListener('dblclick',()=>{vx0=x0;vx1=x1;vy0=y0;vy1=y1;
                                       render();});
  const tip=document.getElementById('tip');
  svg.addEventListener('mousemove',ev=>{
    const m=mpos(ev);
    if(drag){
      const dx=(m[0]-drag[0])/(W-ML-MR)*(drag[3]-drag[2]);
      const dy=(m[1]-drag[1])/(H-MT-MB)*(drag[5]-drag[4]);
      vx0=drag[2]-dx; vx1=drag[3]-dx; vy0=drag[4]+dy; vy1=drag[5]+dy;
      render(); return;
    }
    // hover: nearest visible point
    let best=null,bd=1e18;
    p.traces.forEach((t,ti)=>{
      if(hidden.has(ti)) return;
      for(let i=0;i<t.x.length;i++){
        const dx=sx(t.x[i])-m[0], dy=sy(t.y[i])-m[1];
        const d=dx*dx+dy*dy;
        if(d<bd){bd=d;best=[t,i];}
      }
    });
    if(best&&bd<400){
      tip.style.display='block';
      tip.style.left=(ev.pageX+12)+'px'; tip.style.top=(ev.pageY+12)+'px';
      tip.textContent=(best[0].name?best[0].name+': ':'')+
        fmt(best[0].x[best[1]])+', '+fmt(best[0].y[best[1]]);
    } else tip.style.display='none';
  });
  render();
});
</script></body></html>
"""

"""1024² Re=1000 MAC cavity vs Botella & Peyret — the accuracy north star.

Runs on the accelerator, reports the three centerline-extrema errors at regular
simulated-time checkpoints so temporal-convergence error can be told apart
from the fp32 floor (round-2 snapshot: 2.1e-4 at t=200; BASELINE asks for
~1e-4; at clean 2nd order from 4.3e-4 @ 512² the discretization error at
1024² is ~1.1e-4).

Run:  python examples/cavity_accuracy_1024.py [n] [t_end] [out.npz]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from cfdsim_tpu.cases import lid_cavity_mac
from cfdsim_tpu.utils.cache import enable_compilation_cache
from cfdsim_tpu.validation import botella_peyret_errors

enable_compilation_cache()  # a rerun skips the compile window


def extrema_errors(s, n):
    u = np.asarray(s.u, np.float32)  # upcast: storage may be bf16
    v = np.asarray(s.v, np.float32)
    u_c = u[:, n // 2]
    y_u = (np.arange(n) + 0.5) / n
    v_c = v[n // 2, :]
    x_v = (np.arange(n) + 0.5) / n
    return botella_peyret_errors(u_c, y_u, v_c, x_v)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    t_end = float(sys.argv[2]) if len(sys.argv) > 2 else 400.0
    out = sys.argv[3] if len(sys.argv) > 3 else f"out/cavity_acc_{n}.npz"
    projection = sys.argv[4] if len(sys.argv) > 4 else "chorin"
    resume = sys.argv[5] if len(sys.argv) > 5 else None
    storage = sys.argv[6] if len(sys.argv) > 6 else "fp32"

    case = lid_cavity_mac(n=n, Re=1000.0, projection=projection,
                          storage=storage)
    f = jax.jit(lambda s: jax.lax.scan(
        lambda st, _: case.step(st, jnp.float32(1.0)), s, None,
        length=5000)[0])
    s = case.state
    if resume:
        d = np.load(resume)
        s = s._replace(u=jnp.asarray(d["u"]), v=jnp.asarray(d["v"]),
                       p=jnp.asarray(d["p"]),
                       t=jnp.float32(float(d["t"])),
                       step=jnp.int32(int(d["step"])))
        print(f"resumed from {resume} at t={float(s.t):.1f}", flush=True)
    t0 = time.time()
    next_report = float(s.t) + 25.0
    while float(s.t) < t_end:
        s = f(s)
        t = float(s.t)  # waits for the chunk
        if t >= next_report:
            errs = extrema_errors(s, n)
            print(f"t={t:8.2f}  wall={time.time()-t0:7.1f}s  "
                  f"u_min={errs['u_min']:.3e}  v_max={errs['v_max']:.3e}  "
                  f"v_min={errs['v_min']:.3e}  max={max(errs.values()):.3e}",
                  flush=True)
            next_report += 25.0
    errs = extrema_errors(s, n)
    print(f"FINAL t={float(s.t):.2f} step={int(s.step)} "
          f"max_err={max(errs.values()):.4e} {errs}", flush=True)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, u=np.asarray(s.u, np.float32),
             v=np.asarray(s.v, np.float32), p=np.asarray(s.p),
             t=float(s.t), step=int(s.step))
    print(f"saved {out}", flush=True)


if __name__ == "__main__":
    main()

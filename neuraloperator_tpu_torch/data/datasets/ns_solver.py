"""Batched pseudo-spectral 2-D Navier–Stokes solver on ``torch.fft``.

Port of ``neuraloperator_tpu/data/datasets/ns_solver.py``, the generator of
the flagship's ``nsforcing`` data: forced 2-D incompressible Navier–Stokes
in vorticity form on the unit torus,

    dw/dt + u . grad(w) = visc * Lap(w) + f,   u = rot(psi),  -Lap(psi) = w
    f(x, y) = 0.1 (sin(2 pi (x+y)) + cos(2 pi (x+y)))

with Crank–Nicolson for the viscous term, an explicit step for the
2/3-dealiased advection term, GRF(alpha=2.5, tau=7) initial vorticity and
snapshots every ``record_dt``. The state is the complex half spectrum
``(B, n, n//2+1)`` of ``rfft2`` (the JAX module splits it into real and
imaginary parts only because the TPU runtime restricts complex ops); the
step keeps the JAX step's order of operations, in float32 throughout. On
the card the steps between two snapshots are replayed as a CUDA graph.

``gaussian_rf_vorticity`` is the JAX module's numpy sampler, unchanged, so
initial fields match bit for bit. ``make_nsforcing_split`` builds a split
in memory as ``scripts/generate_ns_data.py`` writes it.
"""

import math

import numpy as np
import torch

from ..._common import resolve_device


def gaussian_rf_vorticity(
    rng: np.random.Generator,
    batch: int,
    n: int,
    alpha: float = 2.5,
    tau: float = 7.0,
) -> np.ndarray:
    """Sample initial vorticity ~ N(0, tau^(2(alpha-1)) (-Lap + tau^2 I)^-alpha).

    Host-side numpy; matches the FNO-paper GaussianRF normalization used to
    build the reference's NS data.
    """
    k = np.fft.fftfreq(n, d=1.0 / n)
    kx, ky = np.meshgrid(k, k, indexing="ij")
    sigma = tau ** (alpha - 1.0)
    sqrt_eig = (
        (n**2)
        * math.sqrt(2.0)
        * sigma
        * (4 * np.pi**2 * (kx**2 + ky**2) + tau**2) ** (-alpha / 2.0)
    )
    sqrt_eig[0, 0] = 0.0
    xi = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal(
        (batch, n, n)
    )
    w0 = np.fft.ifft2(sqrt_eig * xi, axes=(-2, -1)).real
    return np.ascontiguousarray(w0, dtype=np.float32)


def _ns_constants(n: int, forcing_amp: float = 0.1, *, device="cuda"):
    """Real spectral operators for the half-spectrum (rfft2) layout.

    Computed in float64 numpy, then cast to float32, as the JAX module does.
    """
    m = n // 2 + 1
    kx = np.fft.fftfreq(n, d=1.0 / n)[:, None]  # (n, 1) integer freqs
    ky = np.arange(m, dtype=np.float64)[None, :]  # (1, m)
    lap = 4.0 * np.pi**2 * (kx**2 + ky**2)
    lap_safe = lap.copy()
    lap_safe[0, 0] = 1.0
    kmax = n // 2
    dealias = (
        (np.abs(kx) <= (2.0 / 3.0) * kmax) & (np.abs(ky) <= (2.0 / 3.0) * kmax)
    ).astype(np.float64)

    xs = np.linspace(0, 1, n, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    forcing = forcing_amp * (
        np.sin(2 * np.pi * (X + Y)) + np.cos(2 * np.pi * (X + Y))
    )
    f_hat = np.fft.rfft2(forcing)
    consts = dict(
        two_pi_kx=2 * np.pi * kx,
        two_pi_ky=2 * np.pi * ky,
        lap=lap,
        lap_safe=lap_safe,
        dealias=dealias,
        f_hat_re=f_hat.real,
        f_hat_im=f_hat.imag,
    )
    device = resolve_device(device)
    return {
        k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in consts.items()
    }


def _step_operators(c: dict, visc: float, dt: float) -> dict:
    """The step's operators on the complex state, from ``_ns_constants``.

    ``i k`` is the complex ``(0, k)``: its product with ``w`` gives
    ``(-k wi, k wr)`` exactly, the JAX step's split-real derivative. The CN
    factors are formed as the JAX step forms them.
    """
    zero_x, zero_y = torch.zeros_like(c["two_pi_kx"]), torch.zeros_like(c["two_pi_ky"])
    return dict(
        lap_safe=c["lap_safe"],
        i_kx=torch.complex(zero_x, c["two_pi_kx"]),
        i_ky=torch.complex(zero_y, c["two_pi_ky"]),
        minus_i_kx=torch.complex(zero_x, -c["two_pi_kx"]),
        dealias=c["dealias"],
        num=1.0 - 0.5 * dt * visc * c["lap"],
        den=1.0 / (1.0 + 0.5 * dt * visc * c["lap"]),
        dt_f_hat=torch.complex(dt * c["f_hat_re"], dt * c["f_hat_im"]),
    )


def _ns_step(w: torch.Tensor, op: dict, n: int, dt: float) -> torch.Tensor:
    """One CN(viscous)/explicit(advection) step on the rfft2 state ``w``.

    A real factor is applied to the complex state as a product (exact:
    each part is multiplied once), but ``psi`` divides the real and
    imaginary parts themselves: torch's complex division by a real promoted
    to complex multiplies by its reciprocal, which rounds differently.
    """
    psi = torch.view_as_complex(torch.view_as_real(w) / op["lap_safe"][..., None])
    # u = d(psi)/dy -> i*2pi*ky*psi ; v = -d(psi)/dx -> -i*2pi*kx*psi
    u = torch.fft.irfft2(op["i_ky"] * psi, s=(n, n))
    v = torch.fft.irfft2(op["minus_i_kx"] * psi, s=(n, n))
    w_x = torch.fft.irfft2(op["i_kx"] * w, s=(n, n))
    w_y = torch.fft.irfft2(op["i_ky"] * w, s=(n, n))
    adv = torch.fft.rfft2(u * w_x + v * w_y) * op["dealias"]
    return (op["num"] * w - dt * adv + op["dt_f_hat"]) * op["den"]


# steps per CUDA graph replay on the card (a divisor of the steps per record)
GRAPH_STEPS = 100


def _graphed_steps(w: torch.Tensor, op: dict, n: int, dt: float, n_steps: int):
    """A CUDA graph of ``n_steps`` steps from a copy of ``w``, and that copy:
    each replay advances the state held in it by ``n_steps`` steps.

    A step is some twenty small launches whose issue takes longer than
    their work; replayed, the steps run back to back. The graph launches
    the eager step's kernels on the same operands, in the same order."""
    state = w.clone()
    side = torch.cuda.Stream(w.device)
    side.wait_stream(torch.cuda.current_stream(w.device))
    with torch.cuda.stream(side):
        _ns_step(state, op, n, dt)  # warm: cuFFT's plans, before the capture
    torch.cuda.current_stream(w.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x = state
        for _ in range(n_steps):
            x = _ns_step(x, op, n, dt)
        state.copy_(x)
    return graph, state


def _simulate(w0: torch.Tensor, visc, dt, record_steps, steps_per_record, forcing_amp):
    n = w0.shape[-1]
    op = _step_operators(_ns_constants(n, forcing_amp, device=w0.device), visc, dt)
    w = torch.fft.rfft2(w0)
    snaps = w0.new_empty((w0.shape[0], record_steps, n, n))
    if w.is_cuda:
        chunk = math.gcd(steps_per_record, GRAPH_STEPS)
        graph, w = _graphed_steps(w, op, n, dt, chunk)
        for r in range(record_steps):
            for _ in range(steps_per_record // chunk):
                graph.replay()
            snaps[:, r] = torch.fft.irfft2(w, s=(n, n))
        return snaps
    for r in range(record_steps):
        for _ in range(steps_per_record):
            w = _ns_step(w, op, n, dt)
        snaps[:, r] = torch.fft.irfft2(w, s=(n, n))
    return snaps


@torch.inference_mode()
def simulate_navier_stokes_2d(
    w0,
    visc: float = 1e-3,
    T: float = 50.0,
    dt: float = 1e-3,
    record_dt: float = 1.0,
    forcing_amp: float = 0.1,
    *,
    device="cuda",
) -> torch.Tensor:
    """Evolve a batch of vorticity fields, recording every ``record_dt``.

    Parameters
    ----------
    w0 : (B, n, n) float array or tensor — initial vorticity on the unit torus.
    device : where the solver runs, ``"cuda"`` by default.

    Returns
    -------
    (B, record_steps, n, n) float32 snapshots on ``device`` at t =
    record_dt, 2*record_dt, ..., T (the initial condition is NOT included).
    """
    w0 = torch.as_tensor(w0, dtype=torch.float32).to(resolve_device(device))
    steps_per_record = int(round(record_dt / dt))
    record_steps = int(round(T / record_dt))
    if not math.isclose(steps_per_record * dt, record_dt, rel_tol=1e-6):
        raise ValueError(f"record_dt {record_dt} not a multiple of dt {dt}")
    return _simulate(
        w0, float(visc), float(dt), record_steps, steps_per_record, float(forcing_amp)
    )


def generate_nsforcing_trajectories(
    n_trajectories: int,
    res: int,
    visc: float = 1e-3,
    T: float = 50.0,
    dt: float = 1e-3,
    record_dt: float = 1.0,
    seed: int = 0,
    batch: int = 64,
    include_w0: bool = True,
    *,
    device="cuda",
):
    """Generate (n_trajectories, n_snapshots, res, res) forced-NS vorticity.

    Yields numpy blocks of at most ``batch`` trajectories as they finish.
    The initial fields are drawn per block from one ``default_rng(seed)``,
    as the JAX generator draws them, so they are the same fields.
    """
    rng = np.random.default_rng(seed)
    done = 0
    while done < n_trajectories:
        b = min(batch, n_trajectories - done)
        w0 = gaussian_rf_vorticity(rng, b, res)
        traj = simulate_navier_stokes_2d(
            w0, visc=visc, T=T, dt=dt, record_dt=record_dt, device=device
        ).cpu().numpy()
        if include_w0:
            traj = np.concatenate([w0[:, None], traj], axis=1)
        yield traj.astype(np.float32)
        done += b


def trajectories_to_pairs(traj: np.ndarray, stride: int = 1):
    """(B, S, n, n) snapshots -> (B*(S-stride), n, n) x/y pairs w_t -> w_{t+stride}."""
    x = traj[:, :-stride].reshape(-1, *traj.shape[2:])
    y = traj[:, stride:].reshape(-1, *traj.shape[2:])
    return x, y


def trajectories_to_windows(traj: np.ndarray, horizon: int):
    """(B, S, n, n) snapshots -> rollout-training windows.

    Returns ``x`` of shape (M, 1, n, n) and ``y`` of shape
    (M, horizon, 1, n, n): for every start t with t+horizon < S, the input
    w_t and the next ``horizon`` snapshots.
    """
    B, S = traj.shape[:2]
    starts = S - horizon
    if starts <= 0:
        raise ValueError(f"horizon {horizon} too long for {S} snapshots")
    xs, ys = [], []
    for t in range(starts):
        xs.append(traj[:, t])
        ys.append(traj[:, t + 1 : t + 1 + horizon])
    x = np.concatenate(xs)[:, None]  # (M, 1, n, n)
    y = np.concatenate(ys)[:, :, None]  # (M, horizon, 1, n, n)
    return x, y


def make_nsforcing_split(n_traj: int, res: int, seed: int, *, batch: int = 64,
                         device="cuda", **solver_kw):
    """The ``(x, y)`` pairs of one split, built in memory; nothing is written.

    As ``scripts/generate_ns_data.py`` builds ``nsforcing_{split}_{res}.pt``:
    ``n_traj`` trajectories from ``seed`` (the script's test split uses
    ``seed + 10_000``, so 10 000 by default) with ``w0`` included, every
    consecutive pair ``w_t -> w_{t+1}``, shuffled by
    ``default_rng(seed + 1).permutation``. ``solver_kw`` are
    ``generate_nsforcing_trajectories``'s ``visc``, ``T``, ``dt`` and
    ``record_dt``. Returns float32 numpy arrays of shape (pairs, res, res).
    """
    traj = np.concatenate(list(generate_nsforcing_trajectories(
        n_traj, res, seed=seed, batch=batch, device=device, **solver_kw
    )))
    if np.isnan(traj).any():
        raise RuntimeError(f"NaN in the trajectories of seed {seed}")
    xs, ys = trajectories_to_pairs(traj)
    perm = np.random.default_rng(seed + 1).permutation(len(xs))
    return np.ascontiguousarray(xs[perm]), np.ascontiguousarray(ys[perm])

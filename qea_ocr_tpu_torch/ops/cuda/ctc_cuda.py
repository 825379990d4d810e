"""CTC loss (alpha and beta recursions): the CUDA kernels of `csrc/ctc.cu`
and their plain PyTorch versions.

`ctc_nll(log_probs, labels, lengths, pad_id, blank_id)` returns each row's
CTC negative log-likelihood with the semantics of the TPU kernels
(`qea_ocr_tpu/ops/pallas/ctc_pallas.py`): pad labels count as blank, a
zero-length label scores -sum_t log p(blank), and a row no alignment fits
scores exactly 1e5. It is differentiable in `log_probs`: the gradient is the
explicit beta recursion, not autograd through the alpha recursion (which
would turn the -1e30 surrogate of -inf into NaN on a row no alignment fits);
such a row, like a length outside [0, L], has gradient exactly 0. A CPU
tensor takes the plain versions; a CUDA tensor launches the kernels or
raises.

Every function here also takes `logit_lengths`, (B,) integer valid steps a
row in [1, T] (the JAX package's argument of the same name): row b then
uses its first `logit_lengths[b]` steps only, a row no alignment fits in
them scores exactly 1e5, and the gradient is exactly 0 at every later
step. `None` is every row at T, the path the trainers take.
"""

from __future__ import annotations

import ctypes

import torch

from qea_ocr_tpu_torch.ops.cuda import build

NEG = -1e30          # the kernels' -inf surrogate
INFEASIBLE_NLL = 1e5  # clamp for rows no alignment fits
MAX_EXTENDED = 1024  # one thread per extended label: S = 2L+1 <= 1024
GRAD_MAX_SMEM = 232448  # shared memory a block may have on this card

# Kernel launches since the last reset (read and reset by chip_smoke.py):
# the alpha (forward) kernel and the beta/gradient (backward) kernel.
launches = 0
bwd_launches = 0


def band_threads(T: int, L: int) -> int:
    """Threads a row in both kernels (as their launchers compute it): the
    band of extended positions that a row the forward does not clamp can
    reach, min(2L+1, 2T+1), rounded up to whole warps. It is also the last
    dimension of the forward's alpha, (B, T, band_threads(T, L))."""
    return (min(2 * L + 1, 2 * T + 1) + 31) // 32 * 32


def grad_smem_bytes(T: int, V: int, L: int) -> int:
    """Shared memory the backward kernel takes for a row (as its launcher
    computes it), over n = band_threads(T, L) positions: c = beta + E
    (2, n), E and the terms (T, n) each, the gradient (T, V), the blank's
    totals (T), the label's symbols (n / 2)."""
    n = band_threads(T, L)
    return 4 * (2 * n * (T + 1) + T * V + T + n // 2)


def _lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, torch.maximum(b, c))
    ok = m > NEG / 2
    safe = torch.where(ok, m, torch.zeros_like(m))
    out = safe + torch.log(torch.exp(a - safe) + torch.exp(b - safe)
                           + torch.exp(c - safe))
    return torch.where(ok, out, torch.full_like(m, NEG))


def _extend(log_probs: torch.Tensor, labels: torch.Tensor, pad_id: int,
            blank_id: int):
    """Blank-interleaved labels z (B, S), the arrival-skip mask (B, S), the
    column index (S,) and the emissions E[t, b, s] = log_probs[t, b, z[b, s]]
    (-1e30 where z is no valid class)."""
    T, B, V = log_probs.shape
    S = 2 * labels.shape[1] + 1
    dev = log_probs.device
    lab = torch.where(labels == pad_id, blank_id, labels).long()
    z = torch.full((B, S), blank_id, dtype=torch.long, device=dev)
    z[:, 1::2] = lab
    z_m2 = torch.cat([torch.full((B, 2), blank_id, dtype=torch.long,
                                 device=dev), z[:, :-2]], dim=1)
    col = torch.arange(S, device=dev)
    skip = (z != blank_id) & (z != z_m2) & (col >= 2)
    z_ok = (z >= 0) & (z < V)
    z = z.clamp(0, V - 1)
    emit = torch.gather(log_probs.float(), 2, z[None].expand(T, B, S))
    emit = torch.where(z_ok, emit, torch.full_like(emit, NEG))   # (T, B, S)
    return z, skip, col, emit


def check_logit_lengths(log_probs: torch.Tensor,
                        logit_lengths: torch.Tensor) -> torch.Tensor:
    """Raise `ValueError` unless `logit_lengths` is a (B,) integer tensor on
    the log-probs' device with every value in [1, T]; -> it as contiguous
    int32. Reads the values back to the host (one synchronisation)."""
    T, B = log_probs.shape[:2]
    if logit_lengths.dtype.is_floating_point or logit_lengths.dtype in (
            torch.bool, torch.complex64, torch.complex128):
        raise ValueError(f"logit_lengths must be an integer tensor, got "
                         f"{logit_lengths.dtype}")
    if tuple(logit_lengths.shape) != (B,):
        raise ValueError(f"logit_lengths must have shape ({B},), got "
                         f"{tuple(logit_lengths.shape)}")
    if logit_lengths.device != log_probs.device:
        raise ValueError(f"logit_lengths on {logit_lengths.device}, the "
                         f"log-probs on {log_probs.device}")
    if B and not (int(logit_lengths.min()) >= 1
                  and int(logit_lengths.max()) <= T):
        raise ValueError(f"logit_lengths must lie in [1, T={T}], got "
                         f"[{int(logit_lengths.min())}, "
                         f"{int(logit_lengths.max())}]")
    return logit_lengths.to(torch.int32).contiguous()


def _alpha_plain(log_probs, labels, lengths, pad_id, blank_id,
                 logit_lengths=None):
    """-> nll (B,), alpha (T, B, S) over every extended position: the CPU
    layout, which only `ctc_grad_plain` takes. With `logit_lengths` a row's
    alpha stays at its step T_b-1 from there on (optax's carry under
    padding), so the NLL is read at T_b-1."""
    T, B, V = log_probs.shape
    L = labels.shape[1]
    dev = log_probs.device
    _, skip, col, emit = _extend(log_probs, labels, pad_id, blank_id)
    tb = None if logit_lengths is None else logit_lengths.long()[:, None]

    neg2 = torch.full((B, 2), NEG, device=dev)
    a = torch.where(col < 2, emit[0], torch.full_like(emit[0], NEG))
    alphas = [a]
    for t in range(1, T):
        a1 = torch.cat([neg2[:, :1], a[:, :-1]], dim=1)
        a2 = torch.where(skip, torch.cat([neg2, a[:, :-2]], dim=1),
                         torch.full_like(a, NEG))
        step = _lse3(a, a1, a2) + emit[t]
        a = step if tb is None else torch.where(t < tb, step, a)
        alphas.append(a)

    ln = lengths.long()
    in_range = (ln >= 0) & (ln <= L)
    elen = 2 * ln.clamp(0, L) + 1
    last1 = a.gather(1, (elen - 1)[:, None])[:, 0]
    last2 = torch.where(elen >= 2,
                        a.gather(1, (elen - 2).clamp(min=0)[:, None])[:, 0],
                        torch.full_like(last1, NEG))
    m = torch.maximum(last1, last2)
    ok = m > NEG / 2
    safe = torch.where(ok, m, torch.zeros_like(m))
    logz = safe + torch.log(torch.exp(last1 - safe) + torch.exp(last2 - safe))
    nll = torch.where(ok & in_range, -logz,
                      torch.full_like(logz, INFEASIBLE_NLL))
    return torch.clamp(nll, max=INFEASIBLE_NLL), torch.stack(alphas)


def ctc_nll_plain(log_probs: torch.Tensor, labels: torch.Tensor,
                  lengths: torch.Tensor, pad_id: int, blank_id: int = 0,
                  logit_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """log_probs (T, B, V) float32, labels (B, L) int, lengths (B,) int
    -> (B,) float32 NLL. No gradient: `ctc_nll` carries it."""
    if logit_lengths is not None:
        logit_lengths = check_logit_lengths(log_probs, logit_lengths)
    with torch.no_grad():
        return _alpha_plain(log_probs, labels, lengths, pad_id, blank_id,
                            logit_lengths)[0]


def ctc_grad_plain(log_probs: torch.Tensor, labels: torch.Tensor,
                   lengths: torch.Tensor, alpha: torch.Tensor,
                   nll: torch.Tensor, grad_out: torch.Tensor, pad_id: int,
                   blank_id: int = 0,
                   logit_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Beta recursion: d sum_b(grad_out[b] * nll[b]) / d log_probs, (T, B, V),
    from `_alpha_plain`'s alpha (T, B, S) and nll (the same
    `logit_lengths`). Rows with nll == 1e5 get exactly 0; with
    `logit_lengths` a row's beta starts at its own step T_b-1, and its steps
    t >= T_b get exactly 0."""
    if logit_lengths is not None:
        logit_lengths = check_logit_lengths(log_probs, logit_lengths)
    return _grad_plain(log_probs, labels, lengths, alpha, nll, grad_out,
                       pad_id, blank_id, logit_lengths)


def _grad_plain(log_probs, labels, lengths, alpha, nll, grad_out, pad_id,
                blank_id, logit_lengths):
    """`ctc_grad_plain` on `logit_lengths` already checked, or None."""
    T, B, V = log_probs.shape
    L = labels.shape[1]
    dev = log_probs.device
    z, skip, col, emit = _extend(log_probs, labels, pad_id, blank_id)
    # transition s -> s+2 is allowed iff the arrival slot s+2 may be skipped to
    skip_dep = torch.cat([skip[:, 2:], torch.zeros((B, 2), dtype=torch.bool,
                                                   device=dev)], dim=1)
    live = nll < INFEASIBLE_NLL
    elen = (2 * lengths.long().clamp(0, L) + 1)[:, None]
    logz = -nll[:, None]
    neg = torch.full((B, 2), NEG, device=dev)

    b_last = torch.where((col == elen - 1) | (col == elen - 2), 0.0, NEG)
    tb = None if logit_lengths is None else logit_lengths.long()[:, None]
    b = b_last
    grads = [None] * T
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            c = b + emit[t + 1]
            b1 = torch.cat([c[:, 1:], neg[:, :1]], dim=1)
            b2 = torch.where(skip_dep, torch.cat([c[:, 2:], neg], dim=1),
                             torch.full_like(c, NEG))
            b = torch.where(col < elen, _lse3(c, b1, b2),
                            torch.full_like(c, NEG))
            if tb is not None:
                # a row whose last step is t starts its beta here
                b = torch.where(tb == t + 1, b_last, b)
        g = -torch.exp(alpha[t] + b - logz)
        # select, do not multiply: a step past T_b may hold inf
        grads[t] = g if tb is None else torch.where(t < tb, g, 0.0)
    # select, do not multiply: a clamped row's exp may be inf
    d_emit = torch.where(live[None, :, None],
                         torch.stack(grads) * grad_out[None, :, None],
                         torch.zeros((), device=dev))           # (T, B, S)
    # several s share one z (the blank, repeated characters): sum them
    return torch.zeros((T, B, V), device=dev).scatter_add_(
        2, z[None].expand(T, B, -1), d_emit)


def _ptr(t: torch.Tensor | None):
    """A tensor's device address for ctypes, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


def _lib() -> ctypes.CDLL:
    lib = build.load("ctc")
    fn = lib.qea_ctc_alpha_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.qea_ctc_beta_bwd.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.qea_ctc_beta_bwd.restype = ctypes.c_int
        lib.qea_ctc_error_string.argtypes = [ctypes.c_int]
        lib.qea_ctc_error_string.restype = ctypes.c_char_p
    return lib


def _check(log_probs, labels, lengths, grad: bool = False) -> None:
    """Raise for what the kernels do not take, before any launch; `grad`
    adds the backward kernel's limits."""
    if log_probs.dtype != torch.float32 or labels.dtype != torch.int32 \
            or lengths.dtype != torch.int32:
        raise TypeError("CTC kernel takes float32 log-probs and int32 labels "
                        f"and lengths, got {log_probs.dtype}, {labels.dtype}, "
                        f"{lengths.dtype}")
    if log_probs.dim() != 3 or labels.dim() != 2 or lengths.dim() != 1:
        raise ValueError("want log_probs (T, B, V), labels (B, L), lengths "
                         f"(B,); got {tuple(log_probs.shape)}, "
                         f"{tuple(labels.shape)}, {tuple(lengths.shape)}")
    T, B, V = log_probs.shape
    L = labels.shape[1]
    if labels.shape[0] != B or lengths.shape[0] != B:
        raise ValueError(f"batch mismatch: log_probs B={B}, labels "
                         f"{labels.shape[0]}, lengths {lengths.shape[0]}")
    if T < 1 or 2 * L + 1 > MAX_EXTENDED or V < 1:
        raise ValueError(f"CTC kernel takes T >= 1, 2L+1 <= {MAX_EXTENDED} "
                         f"and V >= 1; got T={T}, L={L}, V={V}")
    if grad and grad_smem_bytes(T, V, L) > GRAD_MAX_SMEM:
        raise ValueError(f"CTC backward kernel takes T, V, L whose row fits "
                         f"in {GRAD_MAX_SMEM} bytes of shared memory; got "
                         f"T={T}, L={L}, V={V}: "
                         f"{grad_smem_bytes(T, V, L)} bytes")
    if log_probs.device.type != "cuda" or not (
            log_probs.device == labels.device == lengths.device):
        raise ValueError("CTC kernel takes CUDA tensors on one device, got "
                         f"{log_probs.device}, {labels.device}, "
                         f"{lengths.device}")
    if not (log_probs.is_contiguous() and labels.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("CTC kernel takes contiguous tensors")


def ctc_nll_cuda(log_probs: torch.Tensor, labels: torch.Tensor,
                 lengths: torch.Tensor, pad_id: int, blank_id: int = 0, *,
                 want_alpha: bool = False,
                 logit_lengths: torch.Tensor | None = None):
    """Launch the alpha kernel: log_probs (T, B, V) float32, labels (B, L)
    int32, lengths (B,) int32, all contiguous on one CUDA device. Returns
    nll (B,), or with `want_alpha` the pair (nll, alpha) that `ctc_grad_cuda`
    takes (and then within the backward's limits): alpha over the band only,
    (B, T, band_threads(T, L)), -1e30 at positions s >= 2L+1, unwritten at
    a row's steps t >= logit_lengths[b]. No gradient: `ctc_nll` carries
    it."""
    if logit_lengths is not None:
        logit_lengths = check_logit_lengths(log_probs, logit_lengths)
    return _nll_launch(log_probs, labels, lengths, pad_id, blank_id,
                       want_alpha, logit_lengths)


def _nll_launch(log_probs, labels, lengths, pad_id, blank_id, want_alpha,
                logit_lengths):
    """`ctc_nll_cuda` on `logit_lengths` already checked (int32), or None:
    no read back to the host."""
    global launches
    _check(log_probs, labels, lengths, grad=want_alpha)
    T, B, V = log_probs.shape
    L = labels.shape[1]
    dev = log_probs.device
    lib = _lib()
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    alpha = torch.empty((B, T, band_threads(T, L)), dtype=torch.float32,
                        device=dev) if want_alpha else None
    if B > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.qea_ctc_alpha_fwd(
                log_probs.data_ptr(), labels.data_ptr(), lengths.data_ptr(),
                _ptr(logit_lengths), nll.data_ptr(), _ptr(alpha),
                T, B, V, L, pad_id, blank_id, stream)
        if rc != 0:
            raise RuntimeError("CTC kernel launch failed: "
                               + lib.qea_ctc_error_string(rc).decode())
        launches += 1
    return (nll, alpha) if want_alpha else nll


def ctc_grad_cuda(log_probs: torch.Tensor, labels: torch.Tensor,
                  lengths: torch.Tensor, alpha: torch.Tensor,
                  nll: torch.Tensor, grad_out: torch.Tensor, pad_id: int,
                  blank_id: int = 0,
                  logit_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the beta/gradient kernel on `ctc_nll_cuda(...,
    want_alpha=True)`'s outputs, alpha (B, T, band_threads(T, L)) and nll,
    made with the same `logit_lengths`: -> d log_probs (T, B, V) float32."""
    if logit_lengths is not None:
        logit_lengths = check_logit_lengths(log_probs, logit_lengths)
    return _grad_launch(log_probs, labels, lengths, alpha, nll, grad_out,
                        pad_id, blank_id, logit_lengths)


def _grad_launch(log_probs, labels, lengths, alpha, nll, grad_out, pad_id,
                 blank_id, logit_lengths):
    """`ctc_grad_cuda` on `logit_lengths` already checked (int32), or None:
    no read back to the host."""
    global bwd_launches
    _check(log_probs, labels, lengths, grad=True)
    T, B, V = log_probs.shape
    L = labels.shape[1]
    dev = log_probs.device
    for name, t, shape in (("alpha", alpha, (B, T, band_threads(T, L))),
                           ("nll", nll, (B,)), ("grad_out", grad_out, (B,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"CTC backward takes {name} as contiguous "
                             f"float32 {shape} on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    lib = _lib()
    grad = torch.empty((T, B, V), dtype=torch.float32, device=dev)
    if B == 0:
        return grad
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qea_ctc_beta_bwd(
            log_probs.data_ptr(), labels.data_ptr(), lengths.data_ptr(),
            _ptr(logit_lengths), alpha.data_ptr(), nll.data_ptr(),
            grad_out.data_ptr(),
            grad.data_ptr(), T, B, V, L, pad_id, blank_id, stream)
    if rc != 0:
        raise RuntimeError("CTC backward kernel launch failed: "
                           + lib.qea_ctc_error_string(rc).decode())
    bwd_launches += 1
    return grad


class _CtcNll(torch.autograd.Function):
    """nll with the explicit beta-recursion gradient, on either device.
    `logit_lengths` was checked by `ctc_nll`, or is None: neither pass
    checks it again (no read back to the host)."""

    @staticmethod
    def forward(ctx, log_probs, labels, lengths, pad_id, blank_id,
                logit_lengths):
        if log_probs.device.type == "cuda":
            nll, alpha = _nll_launch(log_probs, labels, lengths, pad_id,
                                     blank_id, True, logit_lengths)
        else:
            nll, alpha = _alpha_plain(log_probs, labels, lengths, pad_id,
                                      blank_id, logit_lengths)
        ctx.save_for_backward(log_probs, labels, lengths, alpha, nll,
                              logit_lengths)
        ctx.ids = (pad_id, blank_id)
        return nll

    @staticmethod
    def backward(ctx, grad_out):
        log_probs, labels, lengths, alpha, nll, logit_lengths = \
            ctx.saved_tensors
        grad_fn = _grad_launch if log_probs.device.type == "cuda" \
            else _grad_plain
        grad = grad_fn(log_probs, labels, lengths, alpha, nll,
                       grad_out.float().contiguous(), *ctx.ids,
                       logit_lengths)
        return grad, None, None, None, None, None


def ctc_nll(log_probs: torch.Tensor, labels: torch.Tensor,
            lengths: torch.Tensor, pad_id: int, blank_id: int = 0,
            logit_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """(T, B, V) log-probs, (B, L) labels, (B,) lengths, optional (B,)
    valid steps -> (B,) NLL, differentiable in the log-probs."""
    if log_probs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no CTC loss for device {log_probs.device}")
    if logit_lengths is not None:
        logit_lengths = check_logit_lengths(log_probs, logit_lengths)
    if log_probs.requires_grad and torch.is_grad_enabled():
        return _CtcNll.apply(log_probs, labels, lengths, pad_id, blank_id,
                             logit_lengths)
    if log_probs.device.type == "cpu":
        with torch.no_grad():
            return _alpha_plain(log_probs, labels, lengths, pad_id, blank_id,
                                logit_lengths)[0]
    return _nll_launch(log_probs, labels, lengths, pad_id, blank_id, False,
                       logit_lengths)

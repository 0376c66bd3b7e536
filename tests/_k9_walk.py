"""A plain emulation of K9's data flow on the card: the gather kernel
(``csrc/plan_spmm_gather.cu``, at every width: the zero columns that pad H to
a multiple of 8 change none of the others) and the split rows' reduction of
``csrc/plan_rows.cuh``, shared by the CPU tests (``test_torch_plan_gather.py``)
and the card's (``test_torch_cuda.py``). Imports only torch and the port, so
it runs where the JAX package does not. Holds no test itself."""

import torch

from sgracex1_tpu_torch.ops import bsr as tbsr

# The split rows' order: for each feature, the partials q of residue w
# (q = w mod FIN_RESIDUES) summed in increasing q from 0, for w = 0 ..
# FIN_RESIDUES - 1, then the residues' sums added in w order from 0.
FIN_RESIDUES = 8


def gather_walk(plan, H):
    """The gather K9's data flow on H's device: Hs = bf16(H) once; each row
    piece sums bf16(f32(Hs[col]) * val) over its slots in slot order from 0;
    a piece of a split row is a partial, and the partials of each split row
    are summed in the order above. f32 adds and products only, so the result
    is the kernel's to the bit."""
    S, P, dev = plan.segments, H.shape[1], H.device
    Hs = tbsr.stage_h_plain(H, None, plan.n_cols, plan.n_cols).to(torch.float32)
    col = plan.slot_cv[:, 0].long()
    val = plan.slot_cv[:, 1].contiguous().view(torch.float32)
    lo, hi = S.seg_lo.long(), S.seg_hi.long()
    acc = torch.zeros((S.n_seg, P), dtype=torch.float32, device=dev)
    for j in range(int((hi - lo).max()) if S.n_seg else 0):
        on = lo + j < hi
        s = (lo + j)[on]
        acc[on] += (Hs[col[s]] * val[s, None]).to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((plan.n_rows, P), dtype=torch.float32, device=dev)
    whole = S.seg_part < 0
    out[S.seg_rb[whole].long()] = acc[whole]
    if S.n_fin:
        partial = torch.zeros((S.n_part, P), dtype=torch.float32, device=dev)
        partial[S.seg_part[~whole].long()] = acc[~whole]
        p0, n = S.fin_p0.long(), S.fin_np.long()
        sums = torch.zeros((FIN_RESIDUES, S.n_fin, P), dtype=torch.float32, device=dev)
        for q in range(int(n.max())):
            on = q < n
            sums[q % FIN_RESIDUES, on] += partial[p0[on] + q]
        total = torch.zeros((S.n_fin, P), dtype=torch.float32, device=dev)
        for w in range(FIN_RESIDUES):
            total = total + sums[w]
        out[S.fin_rb.long()] = total
    return out

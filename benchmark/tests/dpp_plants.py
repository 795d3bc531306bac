"""Faults planted in DPP's plain reference, ``benchmark/nets/dpp.py``, by
rewriting one line of its source: hard targets (``reg_to_class`` of gt
in place of the MPI's soft targets) and the cross-entropy taken without
the ReLU.  A comparison that holds the port to the reference must read
either as wrong."""

# name -> (a source line of nets/dpp.py, its replacement)
PLANTS = {
    'hard_targets': (
        "    t = soft_targets(mpi, r.shape[-1])\n",
        "    c = torch.from_numpy(np.linspace(DISP_MIN, DISP_MAX, r.shape[-1])"
        ".astype(np.float32)).to(gt.device)\n"
        "    half = float(np.float32((DISP_MAX - DISP_MIN) / r.shape[-1]"
        " / 2.0))\n"
        "    t = (torch.abs(c - gt[..., None]) < half).float()\n"),
    'no_relu': ("    r = torch.relu(out['scores'])\n",
                "    r = out['scores']\n"),
}


def planted(src: str, name: str) -> str:
    """``src``, the text of nets/dpp.py, with the fault ``name``."""
    old, new = PLANTS[name]
    if src.count(old) != 1:
        raise ValueError(f'{name}: its line is not in the source once')
    return src.replace(old, new)

"""The port's data path: counterpart of ``tpupose/data/``.

Submodules are imported where they are used, never here, so that
``import tpupose_torch`` loads neither ``h5py`` nor ``cv2``:
``coco_eval`` (OKS AP), ``rle`` and ``tpr`` (over the host libraries of
``tpupose_torch/native/``), ``hdf5``, ``coco_prep`` (the ``prepare``
command), ``pack_tpr`` (pre-padded ``.tpr`` files) and ``pipeline`` (the
training feeds).
"""


def read_samples(path: str, shuffle_seed: int | None = None):
    """Extension-dispatching raw-sample reader: `.tpr` through the
    native inflater, anything else through the HDF5 reader. Same yield
    contract either way (``data/hdf5.py`` module docstring)."""
    if path.endswith(".tpr"):
        from tpupose_torch.data import tpr as mod
    else:
        from tpupose_torch.data import hdf5 as mod
    return mod.read_samples(path, shuffle_seed=shuffle_seed)

"""Result logging, checkpoints and HDF5 tables."""


def import_h5py():
    """Return the ``h5py`` module, or raise an ImportError that names it.

    h5py is an optional dependency (``pip install 'prosper-tpu[h5]'``); only
    the paths that read or write ``.h5`` files need it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading or writing .h5 files needs h5py, an optional "
            "dependency: pip install 'prosper-tpu[h5]'") from e
    return h5py


def h5py_available() -> bool:
    try:
        import_h5py()
    except ImportError:
        return False
    return True

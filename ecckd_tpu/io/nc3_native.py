"""ctypes binding to the native netCDF3 engine (native/ecckd_io).

The native library is the framework's compiled I/O runtime — the counterpart
of the netCDF-C/Fortran stack the reference links against
(rte-ecckd/Makefile:33, mo_simple_netcdf.F90).  It is optional: if
``native/build/libecckd_io.so`` has not been built (``make -C native``),
callers fall back to scipy.io.netcdf transparently (see the ``_NcFile``
facade in io/rfmip.py and ``_CkdFile`` in models/loader.py).
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "build", "libecckd_io.so")
_lib = None

NC_TYPES = {"b": 1, "c": 2, "h": 3, "i": 4, "f": 5, "d": 6}
NP_OF_NC = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.int32,
            5: np.float32, 6: np.float64}


def load_library() -> Optional[ctypes.CDLL]:
    """The shared library, or None if not built."""
    global _lib
    if _lib is not None:
        return _lib
    path = os.environ.get("ECCKD_IO_LIB", os.path.abspath(_LIB_PATH))
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.nc3_open.restype = ctypes.c_void_p
    lib.nc3_open.argtypes = [ctypes.c_char_p]
    lib.nc3_close.argtypes = [ctypes.c_void_p]
    lib.nc3_error.restype = ctypes.c_char_p
    lib.nc3_num_dims.argtypes = [ctypes.c_void_p]
    lib.nc3_dim_name.restype = ctypes.c_char_p
    lib.nc3_dim_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nc3_dim_size.restype = ctypes.c_longlong
    lib.nc3_dim_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nc3_num_vars.argtypes = [ctypes.c_void_p]
    lib.nc3_var_name.restype = ctypes.c_char_p
    lib.nc3_var_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nc3_var_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.nc3_var_ndims.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nc3_var_type.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nc3_var_shape.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_longlong)]
    lib.nc3_read_var_double.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_double)]
    lib.nc3_get_att_text.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.nc3_get_att_double.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_double),
                                       ctypes.c_int]
    lib.nc3w_create.restype = ctypes.c_void_p
    lib.nc3w_create.argtypes = [ctypes.c_char_p]
    lib.nc3w_def_dim.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_longlong]
    lib.nc3w_def_var.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)]
    lib.nc3w_put_att_text.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_char_p]
    lib.nc3w_put_var_double.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_double),
                                        ctypes.c_longlong]
    lib.nc3w_finish.argtypes = [ctypes.c_void_p]
    lib.nc3_update_var_double.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_double),
                                          ctypes.c_longlong]
    _lib = lib
    return lib


class NativeReader:
    """Read-only netCDF3 file via the native engine."""

    def __init__(self, path: str):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native IO library not built "
                               "(run: make -C native)")
        self._lib = lib
        self._h = lib.nc3_open(path.encode())
        if not self._h:
            raise OSError(lib.nc3_error().decode())
        self.dimensions: Dict[str, int] = {}
        for i in range(lib.nc3_num_dims(self._h)):
            self.dimensions[lib.nc3_dim_name(self._h, i).decode()] = \
                int(lib.nc3_dim_size(self._h, i))
        self.var_names = [lib.nc3_var_name(self._h, i).decode()
                          for i in range(lib.nc3_num_vars(self._h))]

    def close(self) -> None:
        if self._h:
            self._lib.nc3_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def has_var(self, name: str) -> bool:
        return self._lib.nc3_var_id(self._h, name.encode()) >= 0

    def var_shape(self, name: str):
        vid = self._vid(name)
        nd = self._lib.nc3_var_ndims(self._h, vid)
        shape = (ctypes.c_longlong * max(nd, 1))()
        self._lib.nc3_var_shape(self._h, vid, shape)
        return tuple(int(shape[i]) for i in range(nd))

    def var_ndims(self, name: str) -> int:
        return self._lib.nc3_var_ndims(self._h, self._vid(name))

    def read(self, name: str) -> np.ndarray:
        """Variable data as float64 in its file shape."""
        vid = self._vid(name)
        shape = self.var_shape(name)
        n = int(np.prod(shape)) if shape else 1
        out = np.empty(n, np.float64)
        rc = self._lib.nc3_read_var_double(
            self._h, vid, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc != 0:
            raise OSError(self._lib.nc3_error().decode())
        return out.reshape(shape)

    def var_type(self, name: str) -> int:
        """netCDF3 external type code of a variable (NC_TYPES values)."""
        return int(self._lib.nc3_var_type(self._h, self._vid(name)))

    def read_exact(self, name: str) -> np.ndarray:
        """Variable data in its FILE dtype (the engine decodes to float64;
        converting back to the stored dtype is lossless for every netCDF3
        external type and keeps the values bit-identical to a scipy read —
        load-time numerics like np.log(pressure) must not depend on which
        engine parsed the file)."""
        return self.read(name).astype(NP_OF_NC[self.var_type(name)])

    def att_text(self, var: Optional[str], name: str) -> Optional[str]:
        vid = -1 if var is None else self._vid(var)
        n = self._lib.nc3_get_att_text(self._h, vid, name.encode(), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(n + 1)
        self._lib.nc3_get_att_text(self._h, vid, name.encode(), buf, n + 1)
        return buf.value.decode()

    def _vid(self, name: str) -> int:
        vid = self._lib.nc3_var_id(self._h, name.encode())
        if vid < 0:
            raise KeyError(f"no variable {name!r}")
        return vid


class NativeWriter:
    """Create a netCDF3 (CDF-2) file via the native engine."""

    def __init__(self, path: str):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native IO library not built")
        self._lib = lib
        self._w = lib.nc3w_create(path.encode())
        self._dims: Dict[str, int] = {}
        self._vars: Dict[str, int] = {}

    def def_dim(self, name: str, size: int) -> int:
        self._dims[name] = self._lib.nc3w_def_dim(self._w, name.encode(),
                                                  size)
        return self._dims[name]

    def def_var(self, name: str, typecode: str,
                dims: Sequence[str]) -> int:
        ids = (ctypes.c_int * len(dims))(*[self._dims[d] for d in dims])
        vid = self._lib.nc3w_def_var(self._w, name.encode(),
                                     NC_TYPES[typecode], len(dims), ids)
        self._vars[name] = vid
        return vid

    def put_att(self, var: Optional[str], name: str, value: str) -> None:
        vid = -1 if var is None else self._vars[var]
        self._lib.nc3w_put_att_text(self._w, vid, name.encode(),
                                    str(value).encode())

    def put_var(self, name: str, data: np.ndarray) -> None:
        arr = np.ascontiguousarray(data, np.float64)
        rc = self._lib.nc3w_put_var_double(
            self._w, self._vars[name],
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), arr.size)
        if rc != 0:
            raise OSError(self._lib.nc3_error().decode())

    def finish(self) -> None:
        rc = self._lib.nc3w_finish(self._w)
        self._w = None
        if rc != 0:
            raise OSError(self._lib.nc3_error().decode())


def update_var(path: str, name: str, data: np.ndarray) -> None:
    """In-place overwrite of an existing variable (template fill, like the
    reference's unblock_and_write; mo_rfmip_io.F90:288-317)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native IO library not built")
    arr = np.ascontiguousarray(data, np.float64)
    rc = lib.nc3_update_var_double(
        path.encode(), name.encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), arr.size)
    if rc != 0:
        raise OSError(lib.nc3_error().decode())

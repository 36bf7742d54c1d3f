"""ctypes binding for the native C++ runtime (bulletin board + trackers).

A copy of `privacy_auction_tpu/runtime/native.py`, so that the PyTorch port
imports nothing of the JAX package; both copies load the one library of
the repository, `native/libpa_runtime.so` (built by `make -C native`, or on
demand by `build_native()`).  The native core owns message storage, byte
metering and timers -- the roles the reference implements in C++
(`SEAL/bulletinBoard.cpp`, `include/dataTracker.h`).

If the shared library is missing and `make` fails, `NativeBoard`,
`BoardClient` and `load()` raise `OSError`; nothing falls back to another
board.  `available()` says whether the library loads (the tests skip
without it).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

# privacy_auction_tpu_torch/runtime/ sits as deep as the JAX package's
# runtime/, so both copies find the same native/ at the repository root
_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libpa_runtime.so"

# protocol phase ids (shared convention with the C side)
PHASE_COMMIT = 0
PHASE_ROUND1 = 1
PHASE_ROUND2 = 2
PHASE_ROUND3 = 3
PHASE_OT_R1 = 4
PHASE_OT_S = 5
PHASE_ANNOUNCE = 6

_lib = None


def build_native() -> bool:
    """Build the shared library with make; True on success."""
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            check=True, capture_output=True, timeout=120,
        )
        return _LIB_PATH.exists()
    except (subprocess.SubprocessError, OSError):
        return False


def load():
    """The loaded library, built first when it is missing."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and not build_native():
        raise OSError(f"native runtime unavailable: {_LIB_PATH}")
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.pa_board_new.restype = ctypes.c_void_p
    lib.pa_board_new.argtypes = [ctypes.c_int64]
    lib.pa_board_free.argtypes = [ctypes.c_void_p]
    lib.pa_board_n_parties.restype = ctypes.c_int64
    lib.pa_board_n_parties.argtypes = [ctypes.c_void_p]
    lib.pa_board_post.restype = ctypes.c_int32
    lib.pa_board_post.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.pa_board_size.restype = ctypes.c_int64
    lib.pa_board_size.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
    ]
    lib.pa_board_fetch.restype = ctypes.c_int64
    lib.pa_board_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.pa_board_account.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.pa_board_bytes.restype = ctypes.c_int64
    lib.pa_board_bytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pa_board_total_bytes.restype = ctypes.c_int64
    lib.pa_board_total_bytes.argtypes = [ctypes.c_void_p]
    lib.pa_timer_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pa_timer_stop.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pa_timer_seconds.restype = ctypes.c_double
    lib.pa_timer_seconds.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pa_board_reset.argtypes = [ctypes.c_void_p]
    # socket hub (multi-process deployment)
    lib.pa_server_start.restype = ctypes.c_void_p
    lib.pa_server_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pa_server_stop.argtypes = [ctypes.c_void_p]
    lib.pa_client_connect.restype = ctypes.c_void_p
    lib.pa_client_connect.argtypes = [ctypes.c_char_p]
    lib.pa_client_close.argtypes = [ctypes.c_void_p]
    lib.pa_client_post.restype = ctypes.c_int32
    lib.pa_client_post.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.pa_client_fetch.restype = ctypes.c_int64
    lib.pa_client_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.pa_client_bytes.restype = ctypes.c_int64
    lib.pa_client_bytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pa_client_total_bytes.restype = ctypes.c_int64
    lib.pa_client_total_bytes.argtypes = [ctypes.c_void_p]
    lib.pa_client_reset.argtypes = [ctypes.c_void_p]
    lib.pa_client_account.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
    ]
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except OSError:
        return False


class NativeBoard:
    """Bulletin board handle backed by the C++ runtime."""

    def __init__(self, n_parties: int):
        self._lib = load()
        self._ptr = self._lib.pa_board_new(n_parties)

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.pa_board_free(ptr)
            self._ptr = None

    @property
    def n_parties(self) -> int:
        return self._lib.pa_board_n_parties(self._ptr)

    def post(self, phase: int, round_: int, party: int, payload: bytes,
             category: str = "bidder"):
        rc = self._lib.pa_board_post(
            self._ptr, phase, round_, party, payload, len(payload),
            category.encode(),
        )
        if rc != 0:
            raise ValueError(f"post failed: {rc}")

    def fetch(self, phase: int, round_: int, party: int,
              category: str = "bidder") -> bytes | None:
        size = self._lib.pa_board_size(self._ptr, phase, round_, party)
        if size < 0:
            return None
        buf = ctypes.create_string_buffer(size)
        got = self._lib.pa_board_fetch(
            self._ptr, phase, round_, party, buf, size, category.encode()
        )
        if got < 0:
            raise RuntimeError(f"fetch failed: {got}")
        return buf.raw[:got]

    def account(self, category: str, nbytes: int):
        self._lib.pa_board_account(self._ptr, category.encode(), nbytes)

    def bytes(self, category: str) -> int:
        return self._lib.pa_board_bytes(self._ptr, category.encode())

    def total_bytes(self) -> int:
        return self._lib.pa_board_total_bytes(self._ptr)

    def timer_start(self, category: str):
        self._lib.pa_timer_start(self._ptr, category.encode())

    def timer_stop(self, category: str):
        self._lib.pa_timer_stop(self._ptr, category.encode())

    def timer_seconds(self, category: str) -> float:
        return self._lib.pa_timer_seconds(self._ptr, category.encode())

    def reset(self):
        self._lib.pa_board_reset(self._ptr)

    def serve(self, sock_path: str) -> "BoardServer":
        """Serve this board to other processes over a Unix-domain socket.

        This is the deployment hub: the reference's BulletinBoard is an
        object every party holds in one process (`SEAL/main.cpp:30`); here
        party processes connect with `BoardClient` and the byte meters
        count real cross-process transfers."""
        return BoardServer(self, sock_path)


class BoardServer:
    """Running socket server for a NativeBoard (stop() or GC to shut down)."""

    def __init__(self, board: NativeBoard, sock_path: str):
        self._board = board  # keep the board alive while serving
        self._lib = board._lib
        self._ptr = self._lib.pa_server_start(board._ptr, sock_path.encode())
        if not self._ptr:
            raise OSError(f"cannot serve board on {sock_path}")
        self.sock_path = sock_path

    def stop(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._lib.pa_server_stop(ptr)

    def __del__(self):
        self.stop()


class BoardClient:
    """Party-process handle to a served board (post/fetch over the socket).

    Connection is retried until connect_timeout_s: party processes may
    come up before the hub finishes binding (or, under load, the hub's
    accept loop may lag), and a party that gives up on first refusal
    would wedge the whole auction.
    """

    def __init__(self, sock_path: str, connect_timeout_s: float = 10.0):
        import time as _time

        self._lib = load()
        deadline = _time.monotonic() + connect_timeout_s
        while True:
            self._ptr = self._lib.pa_client_connect(sock_path.encode())
            if self._ptr:
                break
            if _time.monotonic() > deadline:
                raise OSError(f"cannot connect to board at {sock_path}")
            _time.sleep(0.05)

    def close(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._lib.pa_client_close(ptr)

    def __del__(self):
        self.close()

    def post(self, phase: int, round_: int, party: int, payload: bytes,
             category: str = "bidder"):
        rc = self._lib.pa_client_post(
            self._ptr, phase, round_, party, payload, len(payload),
            category.encode(),
        )
        if rc != 0:
            raise ValueError(f"post failed: {rc}")

    def fetch(self, phase: int, round_: int, party: int,
              category: str = "bidder", max_size: int = 1 << 20):
        # one receive buffer a client, reused: fetch_wait polls this call
        buf = getattr(self, "_buf", None)
        if buf is None or len(buf) < max_size:
            buf = self._buf = ctypes.create_string_buffer(max_size)
        got = self._lib.pa_client_fetch(
            self._ptr, phase, round_, party, buf, max_size, category.encode()
        )
        if got == -1:
            return None
        if got < 0:
            raise RuntimeError(f"fetch failed: {got}")
        return buf.raw[:got]

    def fetch_wait(self, phase: int, round_: int, party: int,
                   category: str = "bidder", timeout_s: float = 30.0,
                   poll_s: float = 0.005):
        """Blocking fetch: poll until the message is posted (the barrier
        semantics of the reference's phase loops, `SEAL/main.cpp:46-120`)."""
        import time as _time

        deadline = _time.monotonic() + timeout_s
        while True:
            msg = self.fetch(phase, round_, party, category)
            if msg is not None:
                return msg
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"no message for (phase={phase}, round={round_}, "
                    f"party={party}) within {timeout_s}s"
                )
            _time.sleep(poll_s)

    def bytes(self, category: str) -> int:
        return self._lib.pa_client_bytes(self._ptr, category.encode())

    def total_bytes(self) -> int:
        return self._lib.pa_client_total_bytes(self._ptr)

    def reset(self):
        self._lib.pa_client_reset(self._ptr)

    def account(self, category: str, nbytes: int):
        self._lib.pa_client_account(self._ptr, category.encode(), nbytes)

"""RDS decoding chain wiring: group_sync -> decoder -> db_handler -> database.

Copy of ``fm_radio_tpu/rds/chain.py`` (imports rewritten), with one
change: ``make_rds_chain("native")`` raises where the native runtime
cannot be built (``runtime.py``) instead of falling back to the Python
chain.

Parity: ``RDS_Decoding_Chain`` (``src/rds_decoder/rds_decoding_chain.h:8-32``).
"""

from __future__ import annotations

import numpy as np

from fm_radio_tpu_torch.rds.database import RDSDatabase, RDSDatabaseHandler
from fm_radio_tpu_torch.rds.decoder import RDSDecoder
from fm_radio_tpu_torch.rds.group_sync import RDSGroupSync
from fm_radio_tpu_torch.rds.manchester import DifferentialManchesterDecoder


class RDSDecodingChain:
    def __init__(self, on_group=None, strict_ref: bool = False,
                 fast_resync: bool = False):
        self.db = RDSDatabase()
        self.db_handler = RDSDatabaseHandler(self.db)
        self.decoder = RDSDecoder(self.db_handler, strict_ref=strict_ref)
        self.log_lines: list[str] = []
        self.groups: list = []
        self._user_on_group = on_group
        self.group_sync = RDSGroupSync(on_group=self._handle_group,
                                       fast_resync=fast_resync)

    def _handle_group(self, group) -> None:
        self.groups.append(group)
        self.log_lines.append(self.decoder.process_group(group))
        if self._user_on_group is not None:
            self._user_on_group(group)

    def process(self, data: np.ndarray) -> None:
        """data: bytes from the Manchester decoder."""
        self.group_sync.process_bytes(data)


class RDSFullChain:
    """Symbols -> database: Manchester + decoding chain, as wired by ``App``
    (``app.cpp:23-34``)."""

    def __init__(self, strict_ref: bool = False, fast_resync: bool = False):
        self.chain = RDSDecodingChain(strict_ref=strict_ref,
                                      fast_resync=fast_resync)
        self.rds_bytes: list[np.ndarray] = []
        self.manchester = DifferentialManchesterDecoder(
            buf_size=16, on_bytes=self._on_bytes
        )

    def _on_bytes(self, buf: np.ndarray) -> None:
        self.rds_bytes.append(buf.copy())
        self.chain.process(buf)

    def process_symbols(self, soft_symbols: np.ndarray) -> None:
        self.manchester.process(soft_symbols)

    @property
    def db(self) -> RDSDatabase:
        return self.chain.db


class NativeRDSFullChain:
    """``RDSFullChain`` drop-in backed by the native Manchester and
    group-sync state machines (``runtime/fmtpu_runtime.cpp``): the
    bit-serial loops run in C++, the group decode and the database stay in
    Python (the same log lines and database).

    It produces no byte-stream artifact (``rds_bytes`` stays empty): the
    Python chain is the scrape artifact path."""

    def __init__(self, strict_ref: bool = False):
        from fm_radio_tpu_torch import runtime as rt
        from fm_radio_tpu_torch.rds.group_sync import RDSBlock

        self._RDSBlock = RDSBlock
        self._native = rt.NativeRDSBitDecoder()
        self.chain = RDSDecodingChain(strict_ref=strict_ref)
        self.rds_bytes: list[np.ndarray] = []

    def process_symbols(self, soft_symbols: np.ndarray) -> None:
        for g in self._native.process_symbols(soft_symbols):
            blocks = [
                self._RDSBlock(data=d, block_type=t, is_valid=v)
                for d, t, v in zip(g["data"], g["types"], g["valid"])
            ]
            self.chain.groups.append(blocks)
            line = self.chain.decoder.process_group(blocks)
            self.chain.log_lines.append(line)

    @property
    def db(self) -> RDSDatabase:
        return self.chain.db


def make_rds_chain(backend: str = "python", strict_ref: bool = False):
    """Chain factory: "python" (byte-artifact parity) or "native" (the C++
    bit loops).  "native" raises ``runtime.NativeRuntimeUnavailable``, with
    the build's error, where the runtime cannot be built: nothing falls
    back to the Python chain in its place."""
    if backend == "native":
        return NativeRDSFullChain(strict_ref=strict_ref)
    return RDSFullChain(strict_ref=strict_ref)

"""26-bit RDS block/group synchronisation.

Parity: ``RDS_Group_Sync`` (``src/rds_decoder/rds_group_sync.{h,cpp}``):
bit-serial shift register; FINDING_SYNC slides until the A-offset syndrome is
zero (``rds_group_sync.cpp:46-74``), then READ_BLOCK consumes fixed 26-bit
frames, 4 blocks/group with offset trial order A, B, C|C1, D
(``:225-252``); >= 3 errored groups resynchronises (``:119-123``).

Host-side by design: ~1.2 kbps/channel of bit-level control flow
(SURVEY.md §2.4).  Batched channels each own an instance.

Copy of ``fm_radio_tpu/rds/group_sync.py`` in the port (imports rewritten).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np

from fm_radio_tpu_torch.rds.crc import OFFSET_WORDS, crc10_bitserial, validate_codeword

log = logging.getLogger("fm_radio_tpu_torch.rds_sync")

BLOCK_BITS = 26
BLOCKS_PER_GROUP = 4
BLOCK_MASK = (1 << BLOCK_BITS) - 1


@dataclasses.dataclass
class RDSBlock:
    data: int = 0
    block_type: str = "A"
    is_valid: bool = False


RDSGroup = list  # list[RDSBlock], length 4


class RDSGroupSync:
    def __init__(self, on_group: Callable | None = None,
                 fast_resync: bool = False):
        """``fast_resync=True`` (opt-in, OFF for reference parity) declares
        desync immediately when a completed group has ALL FOUR blocks
        invalid — unambiguous framing loss (a burst error or a time-shard
        seam), as opposed to the 1-2 invalid blocks of a noisy-but-framed
        stream.  The reference always waits for 3 consecutive errored
        groups (rds_group_sync.cpp:119-123), paying ~3 groups of traffic
        per burst; fast mode pays ~1.  Identical behavior on any stream
        whose groups keep at least one valid block."""
        self.on_group = on_group
        self.fast_resync = fast_resync
        self._buf = 0
        self._buf_bits = 0
        self._group: RDSGroup = [RDSBlock() for _ in range(BLOCKS_PER_GROUP)]
        self._curr_block = 0
        self._block_errors = 0
        self._max_group_desyncs = 3
        self._groups_desync = 0
        self._bits_desync = 0
        self._state = "FINDING_SYNC"

    # -- bit plumbing ------------------------------------------------------

    def _push_bit(self, v: int) -> None:
        self._buf = ((self._buf << 1) | (v & 1)) & BLOCK_MASK

    def process_bytes(self, data: np.ndarray) -> None:
        bits = np.unpackbits(np.asarray(data, dtype=np.uint8))
        self.process_bits(bits)

    def process_bits(self, bits: np.ndarray) -> None:
        i = 0
        n = len(bits)
        while i < n:
            if self._state == "FINDING_SYNC":
                i = self._finding_sync(bits, i)
            else:
                i = self._reading_group(bits, i)

    # -- states ------------------------------------------------------------

    def _finding_sync(self, bits: np.ndarray, i: int) -> int:
        n = len(bits)
        while i < n:
            self._push_bit(int(bits[i]))
            i += 1
            self._bits_desync += 1
            # sync test (rds_group_sync.cpp:58-63): raw CRC of the
            # A-offset-stripped word must be exactly 0 (no correction here)
            if crc10_bitserial(self._buf ^ OFFSET_WORDS["A"]) != 0:
                continue  # counted once above, not twice
            log.info("Locked onto block A after %d bits", self._bits_desync)
            self._state = "READ_BLOCK"
            self._bits_desync = 0
            self._buf_bits = 0
            self._push_block(self._buf)
            break
        return i

    def _reading_group(self, bits: np.ndarray, i: int) -> int:
        n = len(bits)
        while i < n:
            self._push_bit(int(bits[i]))
            i += 1
            self._buf_bits += 1
            if self._buf_bits != BLOCK_BITS:
                continue
            self._buf_bits = 0
            self._push_block(self._buf)
            if self._curr_block < BLOCKS_PER_GROUP:
                continue

            if self.on_group is not None:
                self.on_group([dataclasses.replace(b) for b in self._group])

            total_errors = self._block_errors
            self._curr_block = 0
            self._block_errors = 0
            if total_errors == 0:
                self._groups_desync = 0
                continue
            self._groups_desync += 1
            if self._groups_desync >= self._max_group_desyncs or (
                self.fast_resync and total_errors == BLOCKS_PER_GROUP
            ):
                self._state = "FINDING_SYNC"
                self._groups_desync = 0
                break
        return i

    # -- block decode ------------------------------------------------------

    def _attempt_decode(self, x: int, offset_name: str, block: RDSBlock) -> bool:
        codeword = x ^ OFFSET_WORDS[offset_name]
        is_valid, corrected, pattern, syndrome = validate_codeword(codeword)
        if pattern != 0:
            log.info(
                "%s block=%s, error_pattern=%08X",
                "Corrected" if is_valid else "Uncorrected",
                offset_name,
                pattern,
            )
        if not is_valid and syndrome:
            log.info("Uncorrected block=%s, syndrome=%04X", offset_name, syndrome)
        block.block_type = offset_name
        block.data = (corrected >> 10) & 0xFFFF
        block.is_valid = is_valid
        return is_valid

    def _push_block(self, x: int) -> None:
        if self._curr_block >= BLOCKS_PER_GROUP:
            log.error("Invalid group index %d", self._curr_block)
            return
        block = self._group[self._curr_block]
        block.is_valid = False
        idx = self._curr_block
        if idx == 0:
            self._attempt_decode(x, "A", block)
        elif idx == 1:
            self._attempt_decode(x, "B", block)
        elif idx == 2:
            self._attempt_decode(x, "C", block) or self._attempt_decode(x, "C1", block)
        elif idx == 3:
            self._attempt_decode(x, "D", block)
        self._curr_block += 1
        if not block.is_valid:
            self._block_errors += 1

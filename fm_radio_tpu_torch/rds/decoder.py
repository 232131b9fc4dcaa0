"""RDS group-type decoders.

Parity: ``RDS_Decoder`` (``src/rds_decoder/rds_decoder.cpp:82-540``): version-A
group types 0, 1, 2, 3, 4, 10, 11, 14 implemented; BEYOND the reference (which
leaves every version-B group undecoded) types 0B/1B/2B/14B/15B are also
decoded (``rds_decoder.cpp:128-157``).  One structured log line is produced per group
in the reference's format (``LoggingBuffer``) so stdout-parity tests against
``rds_decode`` are possible.

Copy of ``fm_radio_tpu/rds/decoder.py`` in the port (imports rewritten).
"""

from __future__ import annotations

import logging

from fm_radio_tpu_torch.rds.group_sync import RDSBlock

log = logging.getLogger("fm_radio_tpu_torch.rds_decoder")


def mjd_to_ymd(mjd: int) -> tuple[int, int, int]:
    """Modified Julian Day -> (year, month, day); Fliegel/van Flandern
    (``modified_julian_date.h:8-23``)."""
    j = mjd + 2400001 + 68569
    c = 4 * j // 146097
    j = j - (146097 * c + 3) // 4
    y = 4000 * (j + 1) // 1461001
    j = j - 1461 * y // 4 + 31
    m = 80 * j // 2447
    day = j - 2447 * m // 80
    j = m // 11
    month = m + 2 - 12 * j
    year = 100 * (c - 49) + y + j
    return int(year), int(month), int(day)


class _NullHandler:
    """Absorbs handler calls when no handler is attached."""

    def __getattr__(self, name):
        return lambda *a, **k: None


class RDSDecoder:
    def __init__(self, handler=None, strict_ref: bool = False):
        """``strict_ref=True`` reproduces the reference's behavior exactly:
        EVERY version-B group prints ``Unsupported_Code``
        (``rds_decoder.cpp:146-155``) — required for stdout-parity against
        ``rds_decode`` on streams containing B groups.  Default (False)
        additionally decodes 0B/1B/2B/14B/15B (a strict superset)."""
        self.handler = handler if handler is not None else _NullHandler()
        self.strict_ref = strict_ref
        self._msg: list[str] = []

    def _ap(self, s: str) -> None:
        self._msg.append(s)

    # ------------------------------------------------------------------

    def process_group(self, group: list[RDSBlock]) -> str:
        """Decode one group; returns the log line (also logged)."""
        self._msg = []
        self._ap("[group] [")
        for i, block in enumerate(group):
            self._ap(f"{block.data:04X}" if block.is_valid else "----")
            self._ap(" " if i != 3 else "]")

        block_a, block_b = group[0], group[1]
        pi_code = block_a.data
        descriptor = block_b.data
        group_code = (descriptor >> 12) & 0xF
        version = (descriptor >> 11) & 1
        traffic_id = (descriptor >> 10) & 1
        program_type = (descriptor >> 5) & 0x1F

        self._ap(" ")
        if block_a.is_valid:
            self.handler.on_programme_identifier(pi_code)
            self._ap(f"PI={pi_code:04X}, ")
        else:
            self._ap("         ")

        if block_b.is_valid:
            self._ap(
                f"Type {group_code:2d}{'B' if version else 'A'}, "
                f"TP={traffic_id}, PTY={program_type:2d}, "
            )
            self.handler.on_programme_type(program_type)
            self._on_group_type(group, group_code, bool(version))

        line = "".join(self._msg)
        log.info("%s", line)
        return line

    # ------------------------------------------------------------------

    def _on_group_type(self, group, code: int, version_b: bool) -> bool:
        if not version_b:
            dispatch = {
                0: self._on_group_0a,
                1: self._on_group_1a,
                2: self._on_group_2a,
                3: self._on_group_3a,
                4: self._on_group_4a,
                10: self._on_group_10a,
                11: self._on_group_11a,
                14: self._on_group_14a,
            }
            fn = dispatch.get(code)
            if fn is None:
                self._ap("Unsupported_Code")
                return False
            return fn(group)
        # Version-B groups (block C' carries the PI code; payload shrinks to
        # block D).  The reference declines ALL of these
        # (``rds_decoder.cpp:128-157`` falls through to "unsupported code");
        # this framework decodes the common ones — everything in
        # ``dispatch_b`` below (0B/1B/2B/14B/15B) — a strict superset:
        # version-A-only streams behave identically.  strict_ref restores
        # exact reference behavior for stdout parity.
        if self.strict_ref:
            self._ap("Unsupported_Code")
            return False
        dispatch_b = {
            0: self._on_group_0b,
            1: self._on_group_1b,
            2: self._on_group_2b,
            14: self._on_group_14b,
            15: self._on_group_15b,
        }
        fn = dispatch_b.get(code)
        if fn is None:
            self._ap("Unsupported_Code")
            return False
        return fn(group)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _has(block: RDSBlock, expect: str) -> bool:
        return block.is_valid and block.block_type == expect

    def _print_alt_freq(self, x: int) -> None:
        """AF method A (``rds_decoder.cpp:21-73``)."""
        if x == 0:
            self._ap("Unused")
            return
        if x == 205:
            self._ap("Filler")
            return
        if 224 <= x <= 249:
            self._ap(f"#AF{x - 224}")
            return
        if x == 250:
            self._ap("#LF/MF")
            return
        if 1 <= x <= 204:
            freq = 87_500_000 + x * 100_000
            self._ap(f"VHF={freq * 1e-6:.1f}MHz")
            return
        self._ap("Unassigned")

    # -- group types -------------------------------------------------------

    def _on_group_0a(self, group) -> bool:
        """Type 0A: basic tuning and switching (``rds_decoder.cpp:159-244``)."""
        block_b, block_c, block_d = group[1], group[2], group[3]
        has_c = self._has(block_c, "C")
        has_d = self._has(block_d, "D")

        tp = (block_b.data >> 10) & 1
        ta = (block_b.data >> 4) & 1
        ms = (block_b.data >> 3) & 1
        di = (block_b.data >> 2) & 1
        seg = block_b.data & 0b11

        f0 = (block_c.data >> 8) & 0xFF
        f1 = block_c.data & 0xFF
        c0 = chr((block_d.data >> 8) & 0xFF) if has_d else "?"
        c1 = chr(block_d.data & 0xFF) if has_d else "?"

        self.handler.on_music_speech(bool(ms))
        self.handler.on_traffic_announcement(bool(ta), bool(tp))
        if has_c:
            self.handler.on_alternative_frequency_code(f0, 2 * seg + 0)
            self.handler.on_alternative_frequency_code(f1, 2 * seg + 1)
        if has_d:
            self.handler.on_service_name(c0, 2 * seg + 0)
            self.handler.on_service_name(c1, 2 * seg + 1)

        self._ap(
            f"TA={ta}, M/S={ms}, decoder={di}, segment_address={seg}, "
            f"alt_freqs=[{f0:03d},{f1:03d}] text='{c0}{c1}'"
        )
        self._ap(", ")
        self._ap(f"M/S={'music' if ms else 'speech'}")
        self._ap(", ")
        if seg == 0b00:
            self.handler.on_decoder_is_dynamic_programme_type(bool(di))
            self._ap(f"DI={'dynamic_pty' if di else 'static_pty'}")
        elif seg == 0b01:
            self.handler.on_decoder_is_compressed(bool(di))
            self._ap(f"DI={'compressed' if di else 'not_compressed'}")
        elif seg == 0b10:
            self.handler.on_decoder_is_artificial_head(bool(di))
            self._ap(f"DI={'artificial_head' if di else 'non_artificial_head'}")
        else:
            self.handler.on_decoder_is_stereo(bool(di))
            self._ap(f"DI={'stereo' if di else 'mono'}")

        self._ap(", alt_freq=[")
        if has_c:
            self._print_alt_freq(f0)
            self._ap(",")
            self._print_alt_freq(f1)
        else:
            self._ap("?,?")
        self._ap("]")
        return has_c or has_d

    def _on_group_0b(self, group) -> bool:
        """Type 0B: basic tuning and switching, version B (IEC 62106 §6.1.5.1;
        NOT in the reference — see _on_group_type).  Same block-B payload as
        0A minus the alternative frequencies (block C' repeats the PI)."""
        block_b, block_d = group[1], group[3]
        has_d = self._has(block_d, "D")

        ta = (block_b.data >> 4) & 1
        ms = (block_b.data >> 3) & 1
        di = (block_b.data >> 2) & 1
        seg = block_b.data & 0b11
        tp = (block_b.data >> 10) & 1
        c0 = chr((block_d.data >> 8) & 0xFF) if has_d else "?"
        c1 = chr(block_d.data & 0xFF) if has_d else "?"

        self.handler.on_music_speech(bool(ms))
        self.handler.on_traffic_announcement(bool(ta), bool(tp))
        if has_d:
            self.handler.on_service_name(c0, 2 * seg + 0)
            self.handler.on_service_name(c1, 2 * seg + 1)
        if seg == 0b00:
            self.handler.on_decoder_is_dynamic_programme_type(bool(di))
        elif seg == 0b01:
            self.handler.on_decoder_is_compressed(bool(di))
        elif seg == 0b10:
            self.handler.on_decoder_is_artificial_head(bool(di))
        else:
            self.handler.on_decoder_is_stereo(bool(di))

        self._ap(
            f"TA={ta}, M/S={ms}, decoder={di}, segment_address={seg}, "
            f"text='{c0}{c1}'"
        )
        return has_d

    def _on_group_1b(self, group) -> bool:
        """Type 1B: programme item number, version B (IEC 62106 §6.1.5.2;
        NOT in the reference — see _on_group_type).  Block C' repeats the PI
        so only the paging code (block B) and the PIN day/time (block D,
        same layout as 1A's block D, rds_decoder.cpp:246-300) survive."""
        block_b, block_d = group[1], group[3]
        has_d = self._has(block_d, "D")

        paging_codes = block_b.data & 0x1F
        day = (block_d.data >> 11) & 0x1F
        hour = (block_d.data >> 6) & 0x1F
        minute = block_d.data & 0x3F

        self._ap(f"radio_paging_code={paging_codes}, ")
        if has_d:
            self._ap(f"day={day}, time={hour:02d}:{minute:02d}")
        else:
            self._ap("day=?, time=?")
        return has_d

    def _on_group_2b(self, group) -> bool:
        """Type 2B: RadioText version B — 32 characters, two per group from
        block D (IEC 62106 §6.1.5.3; NOT in the reference)."""
        block_b, block_d = group[1], group[3]
        has_d = self._has(block_d, "D")

        ab_flag = (block_b.data >> 4) & 1
        seg = block_b.data & 0xF
        c0 = chr((block_d.data >> 8) & 0xFF) if has_d else "?"
        c1 = chr(block_d.data & 0xFF) if has_d else "?"

        self.handler.on_radio_text_change(ab_flag)
        if has_d:
            self.handler.on_radio_text(c0, 2 * seg + 0)
            self.handler.on_radio_text(c1, 2 * seg + 1)
        self._ap(f"A/B={ab_flag}, segment_address={seg:2d}, text='{c0}{c1}'")
        return has_d

    def _on_group_14b(self, group) -> bool:
        """Type 14B: EON fast TA switching (superset — the reference
        declines every version-B group, rds_decoder.cpp:146-155).  Block B
        carries TP(ON)/TA(ON) for the cross-referenced network whose PI
        repeats in block D; broadcasters use it to flip a receiver to the
        other network's traffic announcement."""
        block_b, block_d = group[1], group[3]
        if not block_d.is_valid:
            self._ap("PI(on)=?")
            return False
        tp_on = (block_b.data >> 4) & 1
        ta_on = (block_b.data >> 3) & 1
        self._ap(f"TP(on)={tp_on}, TA(on)={ta_on}, PI(on)={block_d.data:04X}")
        return True

    def _on_group_15b(self, group) -> bool:
        """Type 15B: fast basic tuning and switching (IEC 62106 §6.1.5.21;
        NOT in the reference).  Blocks B and D both carry the 0B flag set
        (TA/MS/DI/segment), no PS text — stations repeat it for fast TA
        switching."""
        block_b = group[1]
        ta = (block_b.data >> 4) & 1
        ms = (block_b.data >> 3) & 1
        di = (block_b.data >> 2) & 1
        seg = block_b.data & 0b11
        tp = (block_b.data >> 10) & 1
        self.handler.on_music_speech(bool(ms))
        self.handler.on_traffic_announcement(bool(ta), bool(tp))
        if seg == 0b00:
            self.handler.on_decoder_is_dynamic_programme_type(bool(di))
        elif seg == 0b01:
            self.handler.on_decoder_is_compressed(bool(di))
        elif seg == 0b10:
            self.handler.on_decoder_is_artificial_head(bool(di))
        else:
            self.handler.on_decoder_is_stereo(bool(di))
        self._ap(f"TA={ta}, M/S={ms}, decoder={di}, segment_address={seg}")
        return True

    def _on_group_1a(self, group) -> bool:
        """Type 1A: programme item number / slow labelling
        (``rds_decoder.cpp:246-300``)."""
        block_b, block_c, block_d = group[1], group[2], group[3]
        has_c = self._has(block_c, "C")
        has_d = self._has(block_d, "D")

        paging_codes = block_b.data & 0x1F
        la = (block_c.data >> 15) & 1
        variant = (block_c.data >> 12) & 0b111
        data = block_c.data & 0xFFF
        day = (block_d.data >> 11) & 0x1F
        hour = (block_d.data >> 6) & 0x1F
        minute = block_d.data & 0x3F

        self._ap(f"radio_paging_code={paging_codes}, L/A={la}, variant={variant}")
        self._ap(", ")
        if variant == 0b000:
            paging = (data >> 8) & 0xF
            ecc = data & 0xFF
            self._ap(f"paging={paging}, ecc={ecc:04X}")
        elif variant == 0b001:
            self._ap(f"tmc_id={data:06X}")
        elif variant == 0b010:
            self._ap(f"paging_id={data:06X}")
        elif variant == 0b011:
            self._ap(f"language_code={data:06X}")
        elif variant == 0b110:
            self._ap(f"broadcast_use={data:06X}")
        elif variant == 0b111:
            self._ap(f"EWS_channel_id={data:06X}")
        else:
            self._ap(f"not_assigned_data={data:06X}")
        self._ap(", ")
        self._ap(f"day={day}, time={hour:02d}:{minute:02d}")
        return has_c or has_d

    def _on_group_2a(self, group) -> bool:
        """Type 2A: RadioText (``rds_decoder.cpp:302-337``)."""
        block_b, block_c, block_d = group[1], group[2], group[3]
        has_c = self._has(block_c, "C")
        has_d = self._has(block_d, "D")

        ab_flag = (block_b.data >> 4) & 1
        seg = block_b.data & 0xF
        chars = [
            chr((block_c.data >> 8) & 0xFF) if has_c else "?",
            chr(block_c.data & 0xFF) if has_c else "?",
            chr((block_d.data >> 8) & 0xFF) if has_d else "?",
            chr(block_d.data & 0xFF) if has_d else "?",
        ]
        index = seg * 4
        self.handler.on_radio_text_change(ab_flag)
        if has_c:
            self.handler.on_radio_text(chars[0], index + 0)
            self.handler.on_radio_text(chars[1], index + 1)
        if has_d:
            self.handler.on_radio_text(chars[2], index + 2)
            self.handler.on_radio_text(chars[3], index + 3)
        self._ap(
            f"A/B={ab_flag}, segment_address={seg:2d}, text='{''.join(chars)}'"
        )
        return has_c or has_d

    def _on_group_3a(self, group) -> bool:
        """Type 3A: open-data application id (``rds_decoder.cpp:339-361``)."""
        block_b, block_c, block_d = group[1], group[2], group[3]
        app_code = block_b.data & 0x1F
        app_group = (app_code >> 1) & 0xF
        app_version = app_code & 1
        self._ap(
            f"app_code={app_group}{'B' if app_version else 'A'}, "
            f"message={block_c.data:04X}, AID={block_d.data:04X}"
        )
        return True

    def _on_group_4a(self, group) -> bool:
        """Type 4A: clock-time and date (``rds_decoder.cpp:363-405``)."""
        block_b, block_c, block_d = group[1], group[2], group[3]
        has_c = self._has(block_c, "C")
        has_d = self._has(block_d, "D")

        rfu0 = (block_b.data >> 2) & 0b111
        mjd = ((block_b.data & 0b11) << 15) | ((block_c.data & 0xFFFE) >> 1)
        hour = ((block_c.data & 1) << 4) | ((block_d.data >> 12) & 0xF)
        minute = (block_d.data >> 6) & 0x3F
        lto_sign = (block_d.data >> 5) & 1
        lto_val = block_d.data & 0x1F
        lto = lto_val * (-1 if lto_sign else 1)

        year, month, day = mjd_to_ymd(mjd)
        if has_c:
            self.handler.on_date(day, month, year)
        if has_c and has_d:
            self.handler.on_time(hour, minute)
        if has_d:
            self.handler.on_local_time_offset(lto)
        self._ap(
            f"rfu0={rfu0}, date={day:02d}/{month:02d}/{year:04d}, "
            f"time={hour:02d}:{minute:02d}, LTO={lto}"
        )
        return True

    def _on_group_10a(self, group) -> bool:
        """Type 10A: programme type name (``rds_decoder.cpp:407-443``)."""
        block_b, block_c, block_d = group[1], group[2], group[3]
        has_c = self._has(block_c, "C")
        has_d = self._has(block_d, "D")

        ab_flag = (block_b.data >> 4) & 1
        rfu0 = (block_b.data >> 1) & 0b111
        seg = block_b.data & 1
        chars = [
            chr((block_c.data >> 8) & 0xFF) if has_c else "?",
            chr(block_c.data & 0xFF) if has_c else "?",
            chr((block_d.data >> 8) & 0xFF) if has_d else "?",
            chr(block_d.data & 0xFF) if has_d else "?",
        ]
        index = 4 * seg
        self.handler.on_programme_type_name_change(ab_flag)
        if has_c:
            self.handler.on_programme_type_name(chars[0], index + 0)
            self.handler.on_programme_type_name(chars[1], index + 1)
        if has_d:
            self.handler.on_programme_type_name(chars[2], index + 2)
            self.handler.on_programme_type_name(chars[3], index + 3)
        self._ap(
            f"A/B={ab_flag}, rfu0={rfu0}, segment_addr={seg} text='{''.join(chars)}'"
        )
        return True

    def _on_group_11a(self, group) -> bool:
        """Type 11A: ODA — not specified further (``rds_decoder.cpp:445-452``)."""
        self._ap("TODO")
        return True

    def _on_group_14a(self, group) -> bool:
        """Type 14A: enhanced other networks (``rds_decoder.cpp:454-540``)."""
        block_b, block_c, block_d = group[1], group[2], group[3]
        tp_on = (block_b.data >> 4) & 1
        variant = block_b.data & 0xF
        data = block_c.data
        pi_on = block_d.data

        self._ap(f"TP(on)={tp_on}, variant={variant}")
        self._ap(", ")
        if variant in (0b0000, 0b0001, 0b0010, 0b0011):
            text = chr((data >> 8) & 0xFF) + chr(data & 0xFF)
            self._ap(f"text='{text}'")
        elif variant == 0b0100:
            self._ap("AF(on)=[")
            self._print_alt_freq((data >> 8) & 0xFF)
            self._ap(",")
            self._print_alt_freq(data & 0xFF)
            self._ap("]")
        elif variant in (0b0101, 0b0110, 0b0111, 0b1000):
            self._ap("tuning_freq=?, mapped_fm_freq=?")
        elif variant == 0b1001:
            self._ap("tuning_freq=?, mapped_am_freq=?")
        elif variant == 0b1100:
            self._ap(f"linkage_info={data:04X}")
        elif variant == 0b1101:
            self._ap("bitfield_todo")
        elif variant == 0b1110:
            self._ap(f"PIN(on)={data:04X}")
        elif variant == 0b1111:
            self._ap("reserved_broadcasters")
        else:
            self._ap("Unallocated")
        self._ap(", ")
        self._ap(f"PI(on)={pi_on:04X}")
        return True

"""RDS station database + the handler that fills it.

Parity: ``RDS_Database`` (``src/rds_decoder/rds_database.h:26-80``) and
``RDS_Database_Decoder_Handler`` (``rds_database_decoder_handler.cpp``),
including the TP/TA Table-8 state mapping and the A/B-flag text resets.

Copy of ``fm_radio_tpu/rds/database.py`` in the port (imports rewritten).
"""

from __future__ import annotations

import dataclasses
import enum


class TrafficAnnouncement(enum.Enum):
    NONE = 0
    EON_INFO = 1
    AWAIT_EON_ANNOUNCE = 2
    NOW_EON_ANNOUNCE = 3


@dataclasses.dataclass
class RDSDatabase:
    service_name: list = dataclasses.field(default_factory=lambda: [""] * 8)
    programme_type_name: list = dataclasses.field(default_factory=lambda: [""] * 8)
    radio_text: list = dataclasses.field(default_factory=lambda: [""] * 64)

    programme_type: int = 0
    pi_code: int = 0

    is_stereo: bool = False
    is_music: bool = False
    is_artificial_head: bool = False
    is_compressed: bool = False
    is_dynamic_program_type: bool = False

    alt_freqs: list = dataclasses.field(default_factory=list)  # Hz, sorted
    alt_freq_count: int = 0  # announced AF count (method-A header)

    day: int = 0
    month: int = 0
    year: int = 0
    hour: int = 0
    minute: int = 0
    local_time_offset: int = 0

    traffic_announcement: TrafficAnnouncement = TrafficAnnouncement.NONE

    def reset(self) -> None:
        self.__init__()  # noqa: PLC2801

    @property
    def service_name_str(self) -> str:
        return "".join(c or "\0" for c in self.service_name).rstrip("\0")

    @property
    def radio_text_str(self) -> str:
        return "".join(c or "\0" for c in self.radio_text).rstrip("\0")

    @property
    def programme_type_name_str(self) -> str:
        return "".join(c or "\0" for c in self.programme_type_name).rstrip("\0")

    def summary(self) -> dict:
        """JSON-ready snapshot of the station record (the CLI's output
        contract; the GUI table's fields, render_rds_database.cpp:9-47)."""
        return {
            "pi_code": f"{self.pi_code:04X}",
            "service_name": self.service_name_str,
            "radio_text": self.radio_text_str,
            "programme_type": self.programme_type,
            "alt_freqs_mhz": [f / 1e6 for f in self.alt_freqs],
        }


class RDSDatabaseHandler:
    """The 17-method observer (``rds_decoder_handler.h:4-36``) writing into
    the database (``rds_database_decoder_handler.cpp``)."""

    def __init__(self, db: RDSDatabase):
        self.db = db
        self._ab_flag_ptyn: int | None = None
        self._ab_flag_rt: int | None = None
        self._af_pending: list = []  # list cycle in progress (method A)
        self._af_lfmf_next = False  # code 250: next code is LF/MF

    # identifiers
    def on_programme_identifier(self, pi_code: int) -> None:
        self.db.pi_code = pi_code

    def on_programme_type(self, pty: int) -> None:
        self.db.programme_type = pty

    # text fields ('\r' terminates: mapped to NUL like the reference)
    @staticmethod
    def _ch(c: int | str) -> str:
        c = chr(c) if isinstance(c, int) else c
        return "" if c == "\r" else c

    def on_service_name(self, c, index: int) -> None:
        self.db.service_name[index] = self._ch(c)

    def on_programme_type_name_change(self, ab_flag: int) -> None:
        if ab_flag != self._ab_flag_ptyn:
            self.db.programme_type_name = [""] * 8
        self._ab_flag_ptyn = ab_flag

    def on_programme_type_name(self, c, index: int) -> None:
        self.db.programme_type_name[index] = self._ch(c)

    def on_radio_text_change(self, ab_flag: int) -> None:
        if ab_flag != self._ab_flag_rt:
            self.db.radio_text = [""] * 64
        self._ab_flag_rt = ab_flag

    def on_radio_text(self, c, index: int) -> None:
        self.db.radio_text[index] = self._ch(c)

    # switches
    def on_traffic_announcement(self, ta: bool, tp: bool) -> None:
        v = ((int(tp) & 1) << 1) | (int(ta) & 1)
        self.db.traffic_announcement = TrafficAnnouncement(v)

    def on_music_speech(self, is_music: bool) -> None:
        self.db.is_music = is_music

    # DI bits (Clause 3.2.1.5)
    def on_decoder_is_stereo(self, v: bool) -> None:
        self.db.is_stereo = v

    def on_decoder_is_artificial_head(self, v: bool) -> None:
        self.db.is_artificial_head = v

    def on_decoder_is_compressed(self, v: bool) -> None:
        self.db.is_compressed = v

    def on_decoder_is_dynamic_programme_type(self, v: bool) -> None:
        self.db.is_dynamic_program_type = v

    # AFs — the reference leaves this as TODO
    # (rds_database_decoder_handler.cpp:100-102); completed here per
    # IEC 62106 §6.2.1.6.2 method A: a count header 224+n announces n
    # following AF codes; codes 1..204 are VHF carriers 87.5+0.1*code MHz;
    # code 250 escapes ONE following LF/MF code (1..15 -> LF 153+9(code-1)
    # kHz, 16..135 -> MF 531+9(code-16) kHz).  A list builds in a pending
    # buffer and commits when the announced count is reached, so the
    # database always shows a complete, current cycle (stale entries from a
    # revised list drop out at the next commit).
    def on_alternative_frequency_code(self, code: int, index: int) -> None:
        if self._af_lfmf_next:
            self._af_lfmf_next = False
            if 1 <= code <= 15:
                self._af_add(153_000 + (code - 1) * 9_000)
            elif 16 <= code <= 135:
                self._af_add(531_000 + (code - 16) * 9_000)
            return
        if 224 <= code <= 249:  # count header (#AFn): a new list cycle
            self.db.alt_freq_count = code - 224
            self._af_pending = []
            return
        if code == 250:  # LF/MF escape
            self._af_lfmf_next = True
            return
        if 1 <= code <= 204:  # VHF frequency
            self._af_add(87_500_000 + code * 100_000)

    def _af_add(self, freq_hz: int) -> None:
        if freq_hz not in self._af_pending:
            self._af_pending.append(freq_hz)
        count = self.db.alt_freq_count
        if count and len(self._af_pending) >= count:
            self.db.alt_freqs = sorted(self._af_pending)
            self._af_pending = []
        elif not count:  # no header seen yet: expose what we have
            self.db.alt_freqs = sorted(
                set(self.db.alt_freqs) | {freq_hz}
            )

    # time and date
    def on_date(self, day: int, month: int, year: int) -> None:
        self.db.day, self.db.month, self.db.year = day, month, year

    def on_time(self, hour: int, minute: int) -> None:
        self.db.hour, self.db.minute = hour, minute

    def on_local_time_offset(self, lto: int) -> None:
        self.db.local_time_offset = lto


# ANNEX F, Table F.1 (rds_programme_type_names.h:12-45)
PROGRAMME_TYPES = [
    ("No programme type or undefined", "None", "None"),
    ("News", "News", "News"),
    ("Current Affairs", "Affairs", "Current Affairs"),
    ("Information", "Info", "Information"),
    ("Sport", "Sport", "Sport"),
    ("Education", "Educate", "Education"),
    ("Drama", "Drama", "Drama"),
    ("Culture", "Culture", "Cultures"),
    ("Science", "Science", "Science"),
    ("Varied", "Varied", "Varied Speech"),
    ("Pop Music", "Pop M", "Pop Music"),
    ("Rock Music", "Rock M", "Rock Music"),
    ("Easy Listening Music", "Easy M", "Easy Listening"),
    ("Light classical", "Light M", "Light Classics M"),
    ("Serious classical", "Classics", "Serious Classics"),
    ("Other Music", "Other M", "Other Music"),
    ("Weather", "Weather", "Weather & Metr"),
    ("Finance", "Finance", "Finance"),
    ("Children's programmes", "Children", "Children's Progs"),
    ("Social Affairs", "Social", "Social Affairs"),
    ("Religion", "Religion", "Religion"),
    ("Phone In", "Phone In", "Phone In"),
    ("Travel", "Travel", "Travel & Touring"),
    ("Leisure", "Leisure", "Leisure & Hobby"),
    ("Jazz Music", "Jazz", "Jazz Music"),
    ("Country Music", "Country", "Country Music"),
    ("National Music", "Nation M", "National Music"),
    ("Oldies Music", "Oldies", "Oldies Music"),
    ("Folk Music", "Folk M", "Folk Music"),
    ("Documentary", "Document", "Documentary"),
    ("Alarm Test", "TEST", "Alarm Test"),
    ("Alarm", "Alarm", "Alarm - Alarm !"),
]

"""Mission configuration: CLI flags -> one `Mission` per `-e` flag.

This module defines the whole filter bit-mask model of the framework.
Parity reference: reference/src/mission.rs (Utf8Filter :307-349,
UBF constants :69-161, alias tables :167-274, Missions::new :514-703,
parse_enc_opt :713-749, parse macros :449-504).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .options import (
    ASCII_ENC_LABEL,
    CHARS_MIN_DEFAULT,
    COUNTER_OFFSET_DEFAULT,
    ENCODING_DEFAULT,
    OUTPUT_LINE_CHAR_NB_MAX_DEFAULT,
    OUTPUT_LINE_CHAR_NB_MIN,
    Args,
)
from .encodings import encoding_for_label


class MissionError(ValueError):
    """Raised for invalid command-line mission parameters."""


# --- Unicode-block-filter (UBF) constants (mission.rs:69-161). Each bit
# 0..=63 corresponds to UTF-8 leading byte 0xC0+bit.
UBF_ALL = 0xFFFF_FFFF_FFFF_FFFF
UBF_NONE = 0x0000_0000_0000_0000
UBF_INVALID = 0xFFE0_0000_0000_0003
UBF_ALL_VALID = UBF_ALL & ~UBF_INVALID & UBF_ALL
UBF_LATIN = 0x0000_0000_0000_01FC
UBF_ACCENTS = 0x0000_0000_0000_3000
UBF_GREEK = 0x0000_0000_0000_C000
UBF_IPA = 0x0000_0000_0000_0700
UBF_CYRILLIC = 0x0000_0000_001F_0000
UBF_ARMENIAN = 0x0000_0000_0020_0000
UBF_HEBREW = 0x0000_0000_00C0_0000
UBF_ARABIC = 0x0000_0000_2F00_0000
UBF_SYRIAC = 0x0000_0000_1000_0000
UBF_AFRICAN = 0x0000_0000_FFE0_0000
UBF_COMMON = 0x0000_0000_FFFF_FFFC
UBF_KANA = 0x0000_0008_0000_0000
UBF_CJK = 0x0000_03F0_0000_0000
UBF_HANGUL = 0x0000_3800_0000_0000
UBF_ASIAN = 0x0000_3FFC_0000_0000
UBF_PUA = 0x0010_4000_0000_0000
UBF_MISC = 0x0000_8006_0000_0000
UBF_UNCOMMON = 0x000F_0000_0000_0000

_U64 = (1 << 64) - 1
_U128 = (1 << 128) - 1

# Alias table for the UBF filter (mission.rs:167-218). Names are stored
# 12-char space-padded; lookup is by byte-prefix match in array order, so
# the exact order below is behavior (e.g. "All" matches "All-Asian" first).
UNICODE_BLOCK_FILTER_ALIASSE: List[Tuple[str, int, str]] = [
    ("African     ", UBF_AFRICAN, "all in U+540..U+800      "),
    ("All-Asian   ", (UBF_ALL & ~UBF_INVALID & ~UBF_ASIAN) & _U64, "all, except Asian        "),
    ("All         ", (UBF_ALL & ~UBF_INVALID) & _U64, "all valid multibyte UTF-8"),
    ("Arabic      ", UBF_ARABIC | UBF_SYRIAC, "Arabic+Syriac            "),
    ("Armenian    ", UBF_ARMENIAN, "Armenian                 "),
    ("Asian       ", UBF_ASIAN, "all in U+3000..U+E000    "),
    ("Cjk         ", UBF_CJK, "CJK: U+4000..U+A000      "),
    ("Common      ", UBF_COMMON, "all 2-byte-UFT-8         "),
    ("Cyrillic    ", UBF_CYRILLIC, "Cyrillic                 "),
    ("Default     ", (UBF_ALL & ~UBF_INVALID) & _U64, "all valid multibyte UTF-8"),
    ("Greek       ", UBF_GREEK, "Greek                    "),
    ("Hangul      ", UBF_HANGUL, "Hangul: U+B000..U+E000   "),
    ("Hebrew      ", UBF_HEBREW, "Hebrew                   "),
    ("Kana        ", UBF_KANA, "Kana: U+3000..U+4000     "),
    ("Latin       ", UBF_LATIN | UBF_ACCENTS, "Latin + accents          "),
    ("None        ", (~UBF_ALL) & _U64, "block all multibyte UTF-8"),
    ("Private     ", UBF_PUA, "private use areas        "),
    ("Uncommon    ", UBF_UNCOMMON | UBF_PUA, "private + all>=U+10_000  "),
]

# --- ASCII-filter (AF) constants (mission.rs:220-253). Each bit 0..=127
# corresponds to the ASCII code of a decoded 1-byte UTF-8 character.
AF_ALL = 0xFFFF_FFFF_FFFF_FFFF_FFFF_FFFF_FFFF_FFFE
AF_NONE = 0x0000_0000_0000_0000_0000_0000_0000_0000
AF_CTRL = 0x8000_0000_0000_0000_0000_0000_FFFF_FFFF
AF_WHITESPACE = 0x0000_0000_0000_0000_0000_0001_0000_1E00
AF_DEFAULT = AF_ALL & ~AF_CTRL & _U128

# Alias table for the AF filter (mission.rs:255-274). Same prefix-match
# semantics as the UBF table.
ASCII_FILTER_ALIASSE: List[Tuple[str, int, str]] = [
    ("All         ", AF_ALL, "all ASCII = pass all     "),
    ("All-Ctrl    ", (AF_ALL & ~AF_CTRL) & _U128, "all-control              "),
    ("All-Ctrl+Wsp", ((AF_ALL & ~AF_CTRL) | AF_WHITESPACE) & _U128, "all-control+whitespace   "),
    ("Default     ", AF_DEFAULT, "all-control              "),
    ("None        ", AF_NONE, "block all 1-byte UTF-8   "),
    ("Wsp         ", AF_WHITESPACE, "only white-space         "),
]


@dataclasses.dataclass(frozen=True)
class Utf8Filter:
    """Per-character accept filter over decoded UTF-8 (mission.rs:307-349).

    af:  bit b set => decoded 1-byte char with ASCII code b passes.
    ubf: bit (lead & 0x3f) set => decoded multi-byte char whose UTF-8
         leading byte is `lead` (0xC0..0xFF) passes.
    grep_char: if not None, a finding must contain at least one 1-byte
         char with this ASCII code.
    """

    af: int
    ubf: int
    grep_char: Optional[int]

    def pass_af_filter(self, b: int) -> bool:
        """mission.rs:333-337 - `b` must be <= 0x7f."""
        return ((1 << b) & self.af) != 0

    def pass_ubf_filter(self, b: int) -> bool:
        """mission.rs:341-348 - `b` must be a UTF-8 lead byte > 0x7f."""
        return ((1 << (b & 0x3F)) & self.ubf) != 0


# Default filters (mission.rs:32-50).
UTF8_FILTER_ASCII_MODE_DEFAULT = Utf8Filter(
    af=(AF_ALL & ~AF_CTRL) & _U128, ubf=UBF_NONE, grep_char=None
)
UTF8_FILTER_NON_ASCII_MODE_DEFAULT = Utf8Filter(
    af=(AF_ALL & ~AF_CTRL) & _U128, ubf=UBF_COMMON, grep_char=None
)


@dataclasses.dataclass(frozen=True)
class Mission:
    """Scan instruction parameters (mission.rs:382-421)."""

    mission_id: int
    counter_offset: int
    encoding_name: str  # canonical WHATWG encoding name, e.g. "UTF-8"
    chars_min_nb: int
    require_same_unicode_block: bool
    filter: Utf8Filter
    output_line_char_nb_max: int
    print_encoding_as_ascii: bool

    @property
    def display_encoding_name(self) -> str:
        """Name printed in output metadata (finding.rs:144-148)."""
        return ASCII_ENC_LABEL if self.print_encoding_as_ascii else self.encoding_name


def _parse_integer(s: Optional[str], bits: int, what: str = "number") -> Optional[int]:
    """Port of the `parse_integer!` macro (mission.rs:449-463).

    Accepts decimal or `0x` hex; trims whitespace; empty -> None; range
    checked against an unsigned `bits`-wide integer.
    """
    if s is None:
        return None
    if s == "":
        return None
    t = s.strip()
    # Rust parity (mission.rs:449-463): u64::from_str accepts an
    # optional leading '+' but only ASCII digits (str.isdigit() would
    # also accept Unicode digits); from_str_radix(.., 16) likewise.
    ascii_dec = "0123456789"
    try:
        if len(t) >= 2 and t[:2] == "0x":
            body = t[2:]
            if body[:1] == "+":
                body = body[1:]
            if not body or any(
                c not in "0123456789abcdefABCDEF" for c in body
            ):
                raise ValueError
            v = int(body, 16)
        else:
            body = t[1:] if t[:1] == "+" else t
            if not body or any(c not in ascii_dec for c in body):
                raise ValueError
            v = int(body, 10)
    except ValueError:
        if t[:2] == "0x":
            raise MissionError(f"failed to parse hexadecimal number: `{s}`")
        raise MissionError(f"failed to parse number: {s}")
    if v >= (1 << bits):
        if t[:2] == "0x":
            raise MissionError(f"failed to parse hexadecimal number: `{s}`")
        raise MissionError(f"failed to parse number: {s}")
    return v


def _parse_filter_parameter(
    s: Optional[str], bits: int, aliases: List[Tuple[str, int, str]]
) -> Optional[int]:
    """Port of the `parse_filter_parameter!` macro (mission.rs:475-504).

    `0x` hex literal, or a prefix match against the (ordered) alias table.
    """
    if s is None:
        return None
    t = s.strip()
    if len(t) >= 2 and t[:2] == "0x":
        if (
            not t[2:]
            or any(c not in "0123456789abcdefABCDEF" for c in t[2:])
            or int(t[2:], 16) >= (1 << bits)
        ):
            raise MissionError(f"failed to parse hexadecimal number: `{s}`")
        return int(t[2:], 16)
    if s == "":
        return None
    for name, value, _desc in aliases:
        if len(t) <= len(name) and name[: len(t)] == t:
            return value
    raise MissionError(f"filter name `{t}` is not valid, try `--list-encodings`")


def parse_enc_opt(
    enc_opt: str,
) -> Tuple[Optional[str], Optional[int], Optional[int], Optional[int], Optional[int]]:
    """Parse the `ENC,MIN,AF,UBF,GREP` mini-DSL (mission.rs:713-749)."""
    items = enc_opt.split(",")
    # Rust's split_terminator drops a trailing empty item.
    if items and items[-1] == "":
        items = items[:-1]
    it = iter(items)

    def nxt() -> Optional[str]:
        return next(it, None)

    first = nxt()
    enc_name = None if first is None or first == "" else first.strip()
    chars_min_nb = _parse_integer(nxt(), 8)
    filter_af = _parse_filter_parameter(nxt(), 128, ASCII_FILTER_ALIASSE)
    filter_ubf = _parse_filter_parameter(nxt(), 64, UNICODE_BLOCK_FILTER_ALIASSE)
    grep_char = _parse_integer(nxt(), 8)
    if next(it, None) is not None:
        raise MissionError(f"Too many items in `{enc_opt}`.")
    return (enc_name, chars_min_nb, filter_af, filter_ubf, grep_char)


class Missions:
    """All `Mission` objects for one run (mission.rs:506-703)."""

    def __init__(self, v: List[Mission]):
        self.v = v

    def __len__(self) -> int:
        return len(self.v)

    def __getitem__(self, i: int) -> Mission:
        return self.v[i]

    def __iter__(self):
        return iter(self.v)

    @classmethod
    def from_args(cls, args: Args) -> "Missions":
        return cls.new(
            flag_counter_offset=args.counter_offset,
            flag_encoding=args.encoding,
            flag_chars_min_nb=args.chars_min,
            flag_same_unicode_block=args.same_unicode_block,
            flag_ascii_filter=args.ascii_filter,
            flag_unicode_block_filter=args.unicode_block_filter,
            flag_grep_char=args.grep_char,
            flag_output_line_len=args.output_line_len,
        )

    @classmethod
    def new(
        cls,
        flag_counter_offset: Optional[str] = None,
        flag_encoding: Optional[List[str]] = None,
        flag_chars_min_nb: Optional[str] = None,
        flag_same_unicode_block: bool = False,
        flag_ascii_filter: Optional[str] = None,
        flag_unicode_block_filter: Optional[str] = None,
        flag_grep_char: Optional[str] = None,
        flag_output_line_len: Optional[str] = None,
    ) -> "Missions":
        """Mirrors `Missions::new` (mission.rs:514-703): defaults,
        validation, ASCII emulation via x-user-defined."""
        counter_offset = _parse_integer(flag_counter_offset, 64)
        chars_min_global = _parse_integer(flag_chars_min_nb, 8)
        af_global = _parse_filter_parameter(flag_ascii_filter, 128, ASCII_FILTER_ALIASSE)
        ubf_global = _parse_filter_parameter(
            flag_unicode_block_filter, 64, UNICODE_BLOCK_FILTER_ALIASSE
        )
        grep_global = _parse_integer(flag_grep_char, 8)
        if grep_global is not None and grep_global > 127:
            raise MissionError(
                "you can only `--grep-char` for ASCII codes < 128, "
                f"you tried: `{grep_global}`."
            )
        line_len_global = _parse_integer(flag_output_line_len, 64)
        if line_len_global is not None and line_len_global < OUTPUT_LINE_CHAR_NB_MIN:
            raise MissionError(
                f"minimum for `--output-line-len` is `{OUTPUT_LINE_CHAR_NB_MIN}`, "
                f"you tried: `{line_len_global}`."
            )

        encodings = list(flag_encoding or [])
        if not encodings:
            encodings = [ENCODING_DEFAULT]

        v: List[Mission] = []
        for mission_id, enc_opt in enumerate(encodings):
            enc_name, chars_min_nb, filter_af, filter_ubf, filter_grep = parse_enc_opt(enc_opt)

            if enc_name is None:
                enc_name = ENCODING_DEFAULT
            c_off = counter_offset if counter_offset is not None else COUNTER_OFFSET_DEFAULT
            if chars_min_nb is None:
                chars_min_nb = (
                    chars_min_global if chars_min_global is not None else CHARS_MIN_DEFAULT
                )
            line_len = (
                line_len_global
                if line_len_global is not None
                else OUTPUT_LINE_CHAR_NB_MAX_DEFAULT
            )
            if line_len < OUTPUT_LINE_CHAR_NB_MIN:
                raise MissionError(
                    f"Scanner {chr(mission_id + 97)}: minimum for "
                    f"`--output-line-len` is `{OUTPUT_LINE_CHAR_NB_MIN}`, "
                    f"you tried: `{line_len}`."
                )

            # "ascii" is emulated with x-user-defined + ASCII filter
            # (mission.rs:623-679).
            is_ascii = enc_name == ASCII_ENC_LABEL
            if filter_af is None:
                filter_af = (
                    af_global
                    if af_global is not None
                    else (
                        UTF8_FILTER_ASCII_MODE_DEFAULT.af
                        if is_ascii
                        else UTF8_FILTER_NON_ASCII_MODE_DEFAULT.af
                    )
                )
            if filter_ubf is None:
                filter_ubf = (
                    ubf_global
                    if ubf_global is not None
                    else (
                        UTF8_FILTER_ASCII_MODE_DEFAULT.ubf
                        if is_ascii
                        else UTF8_FILTER_NON_ASCII_MODE_DEFAULT.ubf
                    )
                )
            if filter_grep is None:
                filter_grep = grep_global
            if filter_grep is not None and filter_grep > 127:
                raise MissionError(
                    f"Scanner {chr(mission_id + 97)}: you can only grep for "
                    f"ASCII codes < 128, you tried: `{filter_grep}`."
                )

            print_as_ascii = False
            if is_ascii:
                print_as_ascii = True
                enc_name = "x-user-defined"

            canonical = encoding_for_label(enc_name)
            if canonical is None:
                raise MissionError(
                    f"Scanner {chr(mission_id + 97)}: invalid input encoding "
                    f"name `{enc_name}`, try flag `--list-encodings`."
                )

            v.append(
                Mission(
                    mission_id=mission_id,
                    counter_offset=c_off,
                    encoding_name=canonical,
                    chars_min_nb=chars_min_nb,
                    require_same_unicode_block=flag_same_unicode_block,
                    filter=Utf8Filter(af=filter_af, ubf=filter_ubf, grep_char=filter_grep),
                    output_line_char_nb_max=line_len,
                    print_encoding_as_ascii=print_as_ascii,
                )
            )
        return cls(v)


def mission_from_reference(m) -> Mission:
    """A `stringsext_tpu.mission.Mission` (or any object with its fields)
    as this package's `Mission`, field by field, so one mission set can be
    handed to both packages. The port's only addition to this module."""
    f = m.filter
    return Mission(
        mission_id=m.mission_id,
        counter_offset=m.counter_offset,
        encoding_name=m.encoding_name,
        chars_min_nb=m.chars_min_nb,
        require_same_unicode_block=m.require_same_unicode_block,
        filter=Utf8Filter(af=f.af, ubf=f.ubf, grep_char=f.grep_char),
        output_line_char_nb_max=m.output_line_char_nb_max,
        print_encoding_as_ascii=m.print_encoding_as_ascii,
    )

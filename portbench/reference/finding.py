"""Findings and the bit-exact output line grammar.

Parity reference: reference/src/finding.rs (Precision :31-46,
Finding :51-74, merge order :92-109, print :112-155).
"""

from __future__ import annotations

import dataclasses
from typing import IO, Optional

from .mission import Mission
from .options import Args, Radix

# Precision of Finding.position when the algorithm cannot determine it
# exactly (finding.rs:31-46).
PRECISION_BEFORE = -1
PRECISION_EXACT = 0
PRECISION_AFTER = 1

# Extra space for the byte counter and encoding name in one output line
# (finding.rs:29).
OUTPUT_LINE_METADATA_LEN = 40


@dataclasses.dataclass
class Finding:
    """A decoded string finding with its location (finding.rs:51-74)."""

    input_file_id: Optional[int]  # None = stdin; 1 = first file, ...
    mission: Mission
    position: int
    position_precision: int
    s: bytes  # UTF-8
    s_completes_previous_s: bool

    def sort_key(self):
        """Merge ordering (finding.rs:92-109): position, mission_id,
        then filter ubf / af. The reference's mission_id is truncated
        to u8 at construction (mission.rs:697), so with >256 missions
        the wrapped id ties and the ubf/af tie-breaks become
        reachable - compare the wrapped value for parity."""
        return (
            self.position,
            self.mission.mission_id & 0xFF,
            self.mission.filter.ubf,
            self.mission.filter.af,
        )

    def format(self, args: Args) -> bytes:
        """Port of `Finding::print` (finding.rs:112-155): the line
        emitted for this finding, including its leading newline."""
        out = bytearray(b"\n")
        if not args.no_metadata:
            if len(args.inputs) > 1 and self.input_file_id is not None:
                # map 1 -> 'A', 2 -> 'B' (finding.rs:115-120)
                out += bytes([(self.input_file_id + 64) & 0xFF, 0x20])  # u8 wrap parity
            if args.radix is not None:
                if self.position_precision == PRECISION_AFTER:
                    out += b">"
                elif self.position_precision == PRECISION_EXACT:
                    out += b" "
                else:
                    out += b"<"
                if args.radix == Radix.X:
                    out += format(self.position, "x").encode()
                elif args.radix == Radix.D:
                    out += format(self.position, "d").encode()
                else:
                    out += format(self.position, "o").encode()
                out += b"+\t" if self.s_completes_previous_s else b" \t"
            if len(args.encoding) > 1:
                # map 0 -> 'a', 1 -> 'b' (finding.rs:141-151)
                out += bytes([0x28, (self.mission.mission_id + 97) & 0xFF, 0x20])
                out += self.mission.display_encoding_name.encode()
                out += b")\t"
        out += self.s
        return bytes(out)

    def print(self, out: IO[bytes], args: Args) -> None:
        out.write(self.format(args))

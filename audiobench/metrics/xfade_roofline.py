"""xfade_roofline (%): the least time of the traced window's crossfading
blocks (the frozen count of ``audiobench/roofline_xfade.py``, from the
shapes, supplied by the loop as ``least_s``) over the device time of every
kernel the window ran, whatever their names: ``scan_roofline``'s reader,
under a name of its own because it moves ``audio_s_per_s.opcode``."""

from pathlib import Path

from audiobench import catalog

read = catalog.reader(Path(__file__).resolve().parents[2], "scan_roofline")

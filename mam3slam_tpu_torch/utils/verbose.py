"""Leveled logger (reference Verbose, include/MultiAgentSystem.h:26-51).

Port of ``mam3slam_tpu.utils.verbose``.  Five levels: QUIET < NORMAL <
VERBOSE < VERY_VERBOSE < DEBUG.
"""

QUIET = 0
NORMAL = 1
VERBOSE = 2
VERY_VERBOSE = 3
DEBUG = 4

_level = NORMAL


def set_level(level: int):
    global _level
    _level = level


def print_mess(msg: str, level: int = NORMAL):
    if level <= _level:
        print(msg, flush=True)

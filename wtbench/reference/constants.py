"""WORLD constants (the reference's world_constantnumbers.hpp), the same
values as ``worldtpu.constants``; kept in the port so that the port and its
chip smoke test import nothing of the JAX package.
"""


PI = 3.1415926535897932384
MY_SAFE_GUARD_MINIMUM = 0.000000000001
EPS = 0.00000000000000022204460492503131
FLOOR_F0 = 71.0
CEIL_F0 = 800.0
DEFAULT_F0 = 500.0
LOG2 = 0.69314718055994529
MAXIMUM_VALUE = 100000.0

# D4C
HANNING = 1
BLACKMAN = 2
FREQUENCY_INTERVAL = 3000.0
UPPER_LIMIT = 15000.0
THRESHOLD = 0.85
FLOOR_F0_D4C = 47.0

# Codec (mel scale)
M0 = 1127.01048
F0_MEL = 700.0
FLOOR_FREQUENCY = 40.0
CEIL_FREQUENCY = 20000.0

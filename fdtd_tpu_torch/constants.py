"""Physical constants.

Values match the reference solver's defines (reference: main.c:22-25) so that
field evolution is bit-comparable in fp64.
"""

MU = 1.25663706143591729538505735331180115367886775975e-6
EPSILON = 8.854e-12
PI = 3.14159265358979323846264338327950288419716939937510582097494
CELERITY = 299792458.0

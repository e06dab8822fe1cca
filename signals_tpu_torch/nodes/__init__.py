"""The node library (``signals_tpu.nodes``), ported module by module.

Ported so far: ``fixed``, ``osc`` (Sine, Square, Sawtooth, Triangle), ``fx``
(Mix, RingMod, Gain and the Butterworth LowPass) and ``env`` (ADSR).  Each
node registers the reference-framework qualified names as aliases, exactly
as its ``signals_tpu`` counterpart does.
"""

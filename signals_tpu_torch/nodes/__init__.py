"""The node library (``signals_tpu.nodes``), ported module by module.

Ported so far: ``fixed``, ``osc`` (Sine, Square, Sawtooth, Triangle), ``fx``
(Mix, RingMod, Gain, Amp, Drive and the Butterworth LowPass, HighPass,
BandPass, BandStop, also as ``streaming`` exact IIRs), ``env`` (ADSR) and
``delay`` (Delay).  Each
node registers the reference-framework qualified names as aliases, exactly
as its ``signals_tpu`` counterpart does.
"""

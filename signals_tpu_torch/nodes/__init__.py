"""The node library (``signals_tpu.nodes``), ported module by module.

Ported so far: ``fixed``, ``osc`` (Sine, Square, Sawtooth, Triangle), ``fx``
(Mix, RingMod, Gain, Amp, Drive, Pan, Quantize, the Butterworth LowPass,
HighPass, BandPass, BandStop and the RBJ Peak, LowShelf, HighShelf, Notch,
Allpass, also as ``streaming`` exact IIRs), ``env`` (ADSR), ``delay``
(Delay), ``noise``, ``reverb``, ``dyn``, ``vis``, ``wavetable``
(Wavetable) and ``files`` (FileReader, FileWriter).  Each
node registers the reference-framework qualified names as aliases, exactly
as its ``signals_tpu`` counterpart does.
"""

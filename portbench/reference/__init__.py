"""The benchmark's plain reference: a float64 NumPy decoder of AAC-LC and
HE-AAC v1 (SBR) that imports nothing of the program under test.

The parse (bitio, huffman, syntax, asc, sbr), the tables, the frame
decoder (refdec: dequantization, M/S and intensity stereo, TNS, IMDCT,
windowing and overlap-add) and the SBR reconstruction (sbr_decode: QMF
analysis, HF generation, envelope adjustment, QMF synthesis) are frozen
copies of the port's host modules of the same names, cut to what AAC-LC
and HE-AAC v1 decoding reaches (no Main prediction, LTP, coupling, PCE,
ER or 960-sample syntax; no Parametric Stereo), with the QMF constants
kept in float64 (qmf.py) and one precision hook added (precision.py).
ADTS framing is portbench.corpus.adts_payloads.  decode.py drives them
frame by frame."""

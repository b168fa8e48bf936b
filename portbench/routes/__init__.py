"""How a configuration is driven: one module per route, found by the
configuration's `route`.  A route module gives

  CHECK                 the output check's sample: "pairs" or "slots"
                        (portbench/check.py);
  SBR                   whether the reference applies HE-AAC's SBR;
  OUT_SAMPLES           output samples a frame (at output_rate);
  ROWS                  optional: the rows of the program's PCM each
                        stream takes (the configuration's `channels`
                        where absent);
  OUT_CHANNELS          optional: the output channels of a stream, its
                        first rows there (the configuration's `channels`
                        where absent);
  KEY_FLAGS             the corpus frame flags (portbench.corpus.FLAG_*)
                        that select the program's compiled variant;
  decoder(cell, dev)    the program's decoder for the cell's slots;
  serve(dec, chunks)    the program's serving entry over an iterator of
                        chunks, yielding each chunk's int16 PCM [C, T, S];
  instrument(dec, tr)   the traced run's spans around the program's layers.
"""

"""The block codecs a configuration can name (its ``codec`` key): one module
each, ``codecs/<name>.py``, found by that name. A codec module gives

- ``ENTRY``: the name of the program's function it calls, which the
  benchmark's span around the call takes;
- ``program(config)``: that function, as ``(src, lens, cap) -> (dest,
  comp_lens, err)`` on the card's batch layout (it imports the program);
- ``reference(raw, config)``: the plain reference's compressed bytes of one
  block, where the codec is one a configuration states (it imports nothing
  of the program, and runs in the check's worker processes).
"""

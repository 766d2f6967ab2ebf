"""Frozen transmitter: the port's numpy DVB-S2 modulator (tx/dvbs2_mod.py,
tx/channel.py) and the spec modules it uses, with the LDPC tables npz
byte for byte. The benchmark makes its inputs and judges the receiver's
outputs with these copies, so that the yardstick imports nothing of the
program under test and a later change to the program cannot move it."""

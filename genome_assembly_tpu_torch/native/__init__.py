"""The C++ parity replay engine, built with g++ at first use."""

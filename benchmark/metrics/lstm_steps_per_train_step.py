"""Recurrence steps a stacked train step: the program's traced
``cnn_lstm.lstm_steps`` counter (timesteps x layers of every call of the
LSTM, training and evaluation) over its traced ``engine.train_steps``.
Layer: Model (``models/cnn_lstm.lstm_apply``)."""

from benchmark.core.spans import program_counters


def read(rec):
    counts = program_counters()
    steps = counts.get("engine.train_steps")
    if not steps or "cnn_lstm.lstm_steps" not in counts:
        return None
    return counts["cnn_lstm.lstm_steps"] / steps

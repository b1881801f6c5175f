"""The share (%) of the traced stretch's wall in which the device was idle
while the recurrence ran on the host: inside the program's
``cnn_lstm.lstm`` spans or the library's backward op
(``aten::_cudnn_rnn_backward``; the two never overlap, so their shares
add), in the train cells.  None for a program without the span.  Layer:
Model (``models/cnn_lstm.lstm_apply``)."""

from benchmark.core.spans import idle_pct

SPAN, BACKWARD = "cnn_lstm.lstm", "aten::_cudnn_rnn_backward"


def read(rec):
    forward = idle_pct(rec, SPAN)
    if forward is None:
        return None
    return forward + (idle_pct(rec, BACKWARD) or 0.0)

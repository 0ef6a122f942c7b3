// norma-tpu native audio runtime.
//
// TPU-native re-creation of the reference's native audio muscle, which
// lives in its Rust deps (SURVEY.md §2b):
//   - thingbuf lock-free recycled ring  -> SpscRing (drop-on-full try_send,
//     recycled fixed-capacity slots, short-chunk end-of-stream protocol)
//   - dasp 128-tap sinc resampler       -> SincResampler (streaming)
//   - cpal capture callback DSP         -> mixdown_to_f32 + Packer
//   - cpal/ALSA device layer            -> AlsaCapture via dlopen(libasound)
//     so the library builds and runs (reporting "no devices") on hosts
//     without ALSA installed.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -o libnorma_audio.so norma_audio.cpp -ldl -lpthread

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Lock-free SPSC ring with recycled slots (thingbuf semantics).
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<float> data;
  int64_t len = 0;
};

struct SpscRing {
  std::vector<Slot> slots;
  size_t n;
  int64_t chunk_len;
  std::atomic<uint64_t> head{0};  // next slot to write (producer)
  std::atomic<uint64_t> tail{0};  // next slot to read (consumer)
  std::atomic<bool> closed{false};
  std::atomic<uint64_t> dropped{0};

  SpscRing(size_t n_slots, int64_t chunk) : n(n_slots < 2 ? 2 : n_slots), chunk_len(chunk) {
    slots.resize(n);
    for (auto& s : slots) s.data.resize(static_cast<size_t>(chunk));
  }

  // Producer side: non-blocking, lossy (reference lib.rs:244-252).
  bool try_send(const float* data, int64_t len) {
    uint64_t h = head.load(std::memory_order_relaxed);
    uint64_t t = tail.load(std::memory_order_acquire);
    if (h - t >= n) {
      dropped.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    Slot& s = slots[h % n];
    int64_t m = len < chunk_len ? len : chunk_len;
    std::memcpy(s.data.data(), data, static_cast<size_t>(m) * sizeof(float));
    s.len = m;
    head.store(h + 1, std::memory_order_release);
    return true;
  }

  // Consumer side: copies out; returns length, -1 on timeout, -2 when
  // closed and drained.
  int64_t recv(float* out, int timeout_ms) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    int spins = 0;
    for (;;) {
      uint64_t t = tail.load(std::memory_order_relaxed);
      uint64_t h = head.load(std::memory_order_acquire);
      if (t != h) {
        Slot& s = slots[t % n];
        std::memcpy(out, s.data.data(), static_cast<size_t>(s.len) * sizeof(float));
        int64_t len = s.len;
        tail.store(t + 1, std::memory_order_release);
        return len;
      }
      if (closed.load(std::memory_order_acquire)) return -2;
      if (timeout_ms >= 0 && std::chrono::steady_clock::now() >= deadline)
        return -1;
      if (++spins < 64) {
        std::this_thread::yield();
      } else {
        std::this_thread::sleep_for(std::chrono::microseconds(500));
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Streaming 128-tap windowed-sinc resampler (reference: dasp sinc,
// lib.rs:189-216).  Same math as the Python fallback in audio/resample.py.
// ---------------------------------------------------------------------------

constexpr int kTaps = 128;

struct SincResampler {
  double step;       // src / dst
  double t;          // next output position relative to hist[0]
  double fc;         // anti-alias cutoff, normalized to the source rate
  std::vector<double> hist;
  std::vector<double> win;  // blackman window over taps

  SincResampler(double src_hz, double dst_hz)
      : step(src_hz / dst_hz),
        t(kTaps - 1),
        fc(std::min(1.0, dst_hz / src_hz) * 0.95),
        hist(kTaps, 0.0),
        win(kTaps) {
    for (int i = 0; i < kTaps; ++i) {
      double x = static_cast<double>(i + 1) / (kTaps + 1);
      win[i] = 0.42 - 0.5 * std::cos(2.0 * M_PI * x) +
               0.08 * std::cos(4.0 * M_PI * x);
    }
  }

  static double sinc(double x) {
    if (std::fabs(x) < 1e-12) return 1.0;
    double px = M_PI * x;
    return std::sin(px) / px;
  }

  // Returns number of output samples written (bounded by out_cap; a safe
  // sizing is ceil((n_in + taps) / step) + 1), or -1 when the output would
  // exceed out_cap — in which case nothing is consumed and no state changes,
  // so the caller can retry with a larger buffer.
  int64_t process(const float* in, int64_t n_in, float* out, int64_t out_cap) {
    std::vector<double> x;
    x.reserve(hist.size() + static_cast<size_t>(n_in));
    x.insert(x.end(), hist.begin(), hist.end());
    for (int64_t i = 0; i < n_in; ++i) x.push_back(in[i]);

    const int half = kTaps / 2;
    const int64_t n = static_cast<int64_t>(x.size());
    // Overflow check up front (exact count of the loop below) so a
    // too-small buffer is an error, not a heap overflow.
    {
      double lim = static_cast<double>(n - half);
      int64_t expect =
          t < lim ? static_cast<int64_t>(std::floor((lim - t) / step)) + 1 : 0;
      if (expect > out_cap) return -1;
    }
    int64_t n_out = 0;
    double tt = t;
    while (tt < static_cast<double>(n - half)) {
      int64_t n0 = static_cast<int64_t>(std::floor(tt));
      double frac = tt - static_cast<double>(n0);
      double acc = 0.0, ksum = 0.0;
      const double* w = x.data() + (n0 - half + 1);
      for (int i = 0; i < kTaps; ++i) {
        double k = sinc(fc * (static_cast<double>(i - half + 1) - frac)) * win[i];
        acc += w[i] * k;
        ksum += k;
      }
      out[n_out++] = static_cast<float>(acc / ksum);
      tt += step;
    }
    int64_t cut = static_cast<int64_t>(std::floor(tt)) - half;
    if (cut < 0) cut = 0;
    hist.assign(x.begin() + cut, x.end());
    t = tt - static_cast<double>(cut);
    return n_out;
  }
};

// ---------------------------------------------------------------------------
// Mixdown + sample-format conversion (reference: parse_data!, lib.rs:159-220)
// ---------------------------------------------------------------------------

enum SampleFmt : int {
  FMT_I8 = 0, FMT_I16 = 1, FMT_I32 = 2, FMT_F32 = 3, FMT_F64 = 4,
  FMT_U8 = 5, FMT_U16 = 6, FMT_U32 = 7, FMT_I64 = 8, FMT_U64 = 9,
};

template <typename T, typename Conv>
static void mix_loop(const void* raw, int64_t frames, int ch, float* out, Conv conv) {
  const T* p = static_cast<const T*>(raw);
  for (int64_t f = 0; f < frames; ++f) {
    double acc = 0.0;
    for (int c = 0; c < ch; ++c) acc += conv(p[f * ch + c]);
    out[f] = static_cast<float>(acc / ch);
  }
}

static void mixdown_to_f32(const void* raw, int64_t frames, int ch, int fmt,
                           float* out) {
  switch (fmt) {
    case FMT_I8:
      mix_loop<int8_t>(raw, frames, ch, out, [](int8_t v) { return v / 128.0; });
      break;
    case FMT_I16:
      mix_loop<int16_t>(raw, frames, ch, out, [](int16_t v) { return v / 32768.0; });
      break;
    case FMT_I32:
      mix_loop<int32_t>(raw, frames, ch, out,
                        [](int32_t v) { return v / 2147483648.0; });
      break;
    case FMT_F32:
      mix_loop<float>(raw, frames, ch, out, [](float v) { return (double)v; });
      break;
    case FMT_F64:
      mix_loop<double>(raw, frames, ch, out, [](double v) { return v; });
      break;
    case FMT_U8:
      mix_loop<uint8_t>(raw, frames, ch, out,
                        [](uint8_t v) { return (v - 128.0) / 128.0; });
      break;
    case FMT_U16:
      mix_loop<uint16_t>(raw, frames, ch, out,
                         [](uint16_t v) { return (v - 32768.0) / 32768.0; });
      break;
    case FMT_U32:
      mix_loop<uint32_t>(raw, frames, ch, out, [](uint32_t v) {
        return (v - 2147483648.0) / 2147483648.0;
      });
      break;
    case FMT_I64:
      mix_loop<int64_t>(raw, frames, ch, out,
                        [](int64_t v) { return v / 9223372036854775808.0; });
      break;
    case FMT_U64:
      mix_loop<uint64_t>(raw, frames, ch, out, [](uint64_t v) {
        return (v - 9223372036854775808.0) / 9223372036854775808.0;
      });
      break;
  }
}

// ---------------------------------------------------------------------------
// Packer (reference: lib.rs:224-262): fill to chunk_len, lossy flush; close
// pops one sample so the final chunk is short (end-of-stream signal).
// ---------------------------------------------------------------------------

struct Packer {
  SpscRing* ring;
  std::vector<float> buf;
  int64_t fill = 0;

  explicit Packer(SpscRing* r) : ring(r), buf(static_cast<size_t>(r->chunk_len)) {}

  void append(const float* data, int64_t n) {
    int64_t pos = 0;
    while (pos < n) {
      int64_t space = ring->chunk_len - fill;
      if (space == 0) {
        flush();
        continue;
      }
      int64_t take = std::min(space, n - pos);
      std::memcpy(buf.data() + fill, data + pos,
                  static_cast<size_t>(take) * sizeof(float));
      fill += take;
      pos += take;
    }
  }

  void flush() {
    ring->try_send(buf.data(), fill);
    fill = 0;
  }

  void close() {
    if (fill > 0) fill -= 1;
    flush();
  }
};

// ---------------------------------------------------------------------------
// ALSA capture via dlopen — no ALSA headers/libs needed at build time.
// ---------------------------------------------------------------------------

struct AlsaFns {
  void* lib = nullptr;
  int (*pcm_open)(void**, const char*, int, int) = nullptr;
  int (*pcm_set_params)(void*, int, int, unsigned, unsigned, int, unsigned) = nullptr;
  long (*pcm_readi)(void*, void*, unsigned long) = nullptr;
  int (*pcm_close)(void*) = nullptr;
  int (*pcm_recover)(void*, int, int) = nullptr;
  int (*pcm_wait)(void*, int) = nullptr;
  int (*hint)(int, const char*, void***) = nullptr;
  char* (*hint_get)(const void*, const char*) = nullptr;
  int (*hint_free)(void**) = nullptr;
  // hw-params enumeration (config negotiation, reference lib.rs:527-541)
  size_t (*hw_sizeof)() = nullptr;
  int (*hw_any)(void*, void*) = nullptr;
  int (*hw_test_format)(void*, void*, int) = nullptr;
  int (*hw_get_rate_min)(const void*, unsigned*, int*) = nullptr;
  int (*hw_get_rate_max)(const void*, unsigned*, int*) = nullptr;
  int (*hw_get_channels_min)(const void*, unsigned*) = nullptr;
  int (*hw_get_channels_max)(const void*, unsigned*) = nullptr;
  int (*hw_test_channels)(void*, void*, unsigned) = nullptr;

  bool load() {
    if (lib) return true;
    // NTA_ALSA_LIB overrides the library path: nonstandard ALSA installs,
    // and the hermetic CI stub (tests/stub_alsa) that lets the ranked
    // config-negotiation path execute on hosts with no sound stack.
    const char* override_path = getenv("NTA_ALSA_LIB");
    if (override_path && *override_path)
      lib = dlopen(override_path, RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libasound.so.2", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libasound.so", RTLD_NOW | RTLD_LOCAL);
    if (!lib) return false;
    pcm_open = reinterpret_cast<decltype(pcm_open)>(dlsym(lib, "snd_pcm_open"));
    pcm_set_params = reinterpret_cast<decltype(pcm_set_params)>(
        dlsym(lib, "snd_pcm_set_params"));
    pcm_readi = reinterpret_cast<decltype(pcm_readi)>(dlsym(lib, "snd_pcm_readi"));
    pcm_close = reinterpret_cast<decltype(pcm_close)>(dlsym(lib, "snd_pcm_close"));
    pcm_recover =
        reinterpret_cast<decltype(pcm_recover)>(dlsym(lib, "snd_pcm_recover"));
    pcm_wait = reinterpret_cast<decltype(pcm_wait)>(dlsym(lib, "snd_pcm_wait"));
    hint = reinterpret_cast<decltype(hint)>(dlsym(lib, "snd_device_name_hint"));
    hint_get = reinterpret_cast<decltype(hint_get)>(
        dlsym(lib, "snd_device_name_get_hint"));
    hint_free = reinterpret_cast<decltype(hint_free)>(
        dlsym(lib, "snd_device_name_free_hint"));
    hw_sizeof = reinterpret_cast<decltype(hw_sizeof)>(
        dlsym(lib, "snd_pcm_hw_params_sizeof"));
    hw_any = reinterpret_cast<decltype(hw_any)>(dlsym(lib, "snd_pcm_hw_params_any"));
    hw_test_format = reinterpret_cast<decltype(hw_test_format)>(
        dlsym(lib, "snd_pcm_hw_params_test_format"));
    hw_get_rate_min = reinterpret_cast<decltype(hw_get_rate_min)>(
        dlsym(lib, "snd_pcm_hw_params_get_rate_min"));
    hw_get_rate_max = reinterpret_cast<decltype(hw_get_rate_max)>(
        dlsym(lib, "snd_pcm_hw_params_get_rate_max"));
    hw_get_channels_min = reinterpret_cast<decltype(hw_get_channels_min)>(
        dlsym(lib, "snd_pcm_hw_params_get_channels_min"));
    hw_get_channels_max = reinterpret_cast<decltype(hw_get_channels_max)>(
        dlsym(lib, "snd_pcm_hw_params_get_channels_max"));
    hw_test_channels = reinterpret_cast<decltype(hw_test_channels)>(
        dlsym(lib, "snd_pcm_hw_params_test_channels"));
    return pcm_open && pcm_set_params && pcm_readi && pcm_close;
  }

  bool can_enumerate() const {
    return hw_sizeof && hw_any && hw_test_format && hw_get_rate_min &&
           hw_get_rate_max && hw_get_channels_min && hw_get_channels_max;
  }
};

// Our SampleFmt <-> ALSA snd_pcm_format_t.  ALSA has no 64-bit integer PCM
// formats, so of the reference's 10 cpal formats 8 are reachable on Linux
// (cpal's ALSA host exposes the same 8).
struct FmtMap {
  int fmt;        // SampleFmt
  int alsa;       // snd_pcm_format_t
  int bytes;      // bytes per sample
};
constexpr FmtMap kFmtMap[] = {
    {FMT_I8, 0, 1},    // SND_PCM_FORMAT_S8
    {FMT_U8, 1, 1},    // SND_PCM_FORMAT_U8
    {FMT_I16, 2, 2},   // SND_PCM_FORMAT_S16_LE
    {FMT_U16, 4, 2},   // SND_PCM_FORMAT_U16_LE
    {FMT_I32, 10, 4},  // SND_PCM_FORMAT_S32_LE
    {FMT_U32, 12, 4},  // SND_PCM_FORMAT_U32_LE
    {FMT_F32, 14, 4},  // SND_PCM_FORMAT_FLOAT_LE
    {FMT_F64, 16, 8},  // SND_PCM_FORMAT_FLOAT64_LE
};

static const FmtMap* fmt_entry(int fmt) {
  for (const auto& m : kFmtMap)
    if (m.fmt == fmt) return &m;
  return nullptr;
}

AlsaFns g_alsa;

struct AlsaCapture {
  void* pcm = nullptr;
  SpscRing* ring = nullptr;
  Packer* packer = nullptr;
  SincResampler* resampler = nullptr;
  std::thread worker;
  std::atomic<bool> stop{false};
  unsigned rate = 0;
  unsigned channels = 0;

  ~AlsaCapture() {
    delete packer;
    delete resampler;
  }
};

}  // namespace

extern "C" {

// ---- ring ----------------------------------------------------------------

void* nta_ring_new(int64_t n_slots, int64_t chunk_len) {
  return new SpscRing(static_cast<size_t>(n_slots), chunk_len);
}
int nta_ring_try_send(void* r, const float* data, int64_t len) {
  return static_cast<SpscRing*>(r)->try_send(data, len) ? 1 : 0;
}
int64_t nta_ring_recv(void* r, float* out, int timeout_ms) {
  return static_cast<SpscRing*>(r)->recv(out, timeout_ms);
}
void nta_ring_close(void* r) {
  static_cast<SpscRing*>(r)->closed.store(true, std::memory_order_release);
}
uint64_t nta_ring_dropped(void* r) {
  return static_cast<SpscRing*>(r)->dropped.load(std::memory_order_relaxed);
}
int64_t nta_ring_chunk_len(void* r) { return static_cast<SpscRing*>(r)->chunk_len; }
void nta_ring_free(void* r) { delete static_cast<SpscRing*>(r); }

// ---- resampler -----------------------------------------------------------

void* nta_resampler_new(double src_hz, double dst_hz) {
  return new SincResampler(src_hz, dst_hz);
}
int64_t nta_resampler_process(void* rs, const float* in, int64_t n_in,
                              float* out, int64_t max_out) {
  return static_cast<SincResampler*>(rs)->process(in, n_in, out, max_out);
}
void nta_resampler_free(void* rs) { delete static_cast<SincResampler*>(rs); }

// ---- mixdown -------------------------------------------------------------

void nta_mixdown(const void* raw, int64_t frames, int channels, int fmt,
                 float* out) {
  mixdown_to_f32(raw, frames, channels, fmt, out);
}

// ---- packer --------------------------------------------------------------

void* nta_packer_new(void* ring) {
  return new Packer(static_cast<SpscRing*>(ring));
}
void nta_packer_append(void* p, const float* data, int64_t n) {
  static_cast<Packer*>(p)->append(data, n);
}
void nta_packer_close(void* p) { static_cast<Packer*>(p)->close(); }
void nta_packer_free(void* p) { delete static_cast<Packer*>(p); }

// ---- ALSA ----------------------------------------------------------------

int nta_alsa_available() { return g_alsa.load() ? 1 : 0; }

// Enumerate capture device names into a user buffer ('\n'-separated).
int64_t nta_alsa_devices(char* out, int64_t cap) {
  if (!g_alsa.load() || !g_alsa.hint) return -1;
  void** hints = nullptr;
  if (g_alsa.hint(-1, "pcm", &hints) < 0) return -1;
  int64_t written = 0;
  for (void** h = hints; *h != nullptr; ++h) {
    char* ioid = g_alsa.hint_get(*h, "IOID");
    bool input_ok = (ioid == nullptr) || (std::strcmp(ioid, "Input") == 0);
    if (ioid) free(ioid);
    if (!input_ok) continue;
    char* name = g_alsa.hint_get(*h, "NAME");
    if (!name) continue;
    int64_t len = static_cast<int64_t>(std::strlen(name));
    if (written + len + 1 < cap) {
      std::memcpy(out + written, name, static_cast<size_t>(len));
      written += len;
      out[written++] = '\n';
    }
    free(name);
  }
  if (g_alsa.hint_free) g_alsa.hint_free(hints);
  if (written > 0) out[written - 1] = '\0';
  else if (cap > 0) out[0] = '\0';
  return written;
}

// Enumerate the device's supported stream configs (the cpal
// SupportedStreamConfigRange equivalent, reference lib.rs:527-541): for each
// supported (sample format x channel count), one line
// "fmt,min_rate,max_rate,channels\n" into the user buffer.  Returns bytes
// written, 0 when the device opens but exposes nothing, -1 on failure.
int64_t nta_alsa_query_configs(const char* device, char* out, int64_t cap_len) {
  if (!g_alsa.load() || !g_alsa.can_enumerate()) return -1;
  void* pcm = nullptr;
  if (g_alsa.pcm_open(&pcm, device, 1, 0) < 0) return -1;  // capture, blocking
  std::vector<char> hw(g_alsa.hw_sizeof(), 0);
  int64_t written = 0;
  if (g_alsa.hw_any(pcm, hw.data()) >= 0) {
    unsigned rmin = 0, rmax = 0, cmin = 0, cmax = 0;
    int dir = 0;
    g_alsa.hw_get_rate_min(hw.data(), &rmin, &dir);
    g_alsa.hw_get_rate_max(hw.data(), &rmax, &dir);
    g_alsa.hw_get_channels_min(hw.data(), &cmin);
    g_alsa.hw_get_channels_max(hw.data(), &cmax);
    if (cmax > 32) cmax = 32;  // cap pathological plugin ranges
    for (const auto& m : kFmtMap) {
      if (g_alsa.hw_test_format(pcm, hw.data(), m.alsa) < 0) continue;
      for (unsigned ch = cmin; ch <= cmax; ++ch) {
        if (g_alsa.hw_test_channels &&
            g_alsa.hw_test_channels(pcm, hw.data(), ch) < 0)
          continue;
        char line[96];
        int n = std::snprintf(line, sizeof(line), "%d,%u,%u,%u\n", m.fmt,
                              rmin, rmax, ch);
        if (n > 0 && written + n < cap_len) {
          std::memcpy(out + written, line, static_cast<size_t>(n));
          written += n;
        }
      }
    }
  }
  g_alsa.pcm_close(pcm);
  if (written < cap_len) out[written] = '\0';
  return written;
}

// Start capture: device -> mixdown (any of the 8 ALSA-reachable sample
// formats) -> (resample) -> packer -> ring.  ``fmt`` is a SampleFmt value;
// target_rate is the model rate.
void* nta_alsa_start_fmt(const char* device, unsigned dev_rate,
                         unsigned channels, int fmt, unsigned target_rate,
                         void* ring) {
  if (!g_alsa.load()) return nullptr;
  const FmtMap* fm = fmt_entry(fmt);
  if (!fm) return nullptr;
  auto* cap = new AlsaCapture();
  // SND_PCM_STREAM_CAPTURE = 1.  When snd_pcm_wait is available, open in
  // NONBLOCK mode (SND_PCM_NONBLOCK = 1) and poll with a bounded wait so the
  // worker re-checks the stop flag even if the device stalls without error —
  // a blocking snd_pcm_readi on a starved PCM would otherwise hang
  // nta_alsa_stop's join forever.  Without snd_pcm_wait (minimal stubs),
  // fall back to blocking reads.
  const bool nonblock = g_alsa.pcm_wait != nullptr;
  if (g_alsa.pcm_open(&cap->pcm, device, 1, nonblock ? 1 : 0) < 0) {
    delete cap;
    return nullptr;
  }
  // SND_PCM_ACCESS_RW_INTERLEAVED = 3.
  if (g_alsa.pcm_set_params(cap->pcm, fm->alsa, 3, channels, dev_rate, 1,
                            100000) < 0) {
    g_alsa.pcm_close(cap->pcm);
    delete cap;
    return nullptr;
  }
  cap->rate = dev_rate;
  cap->channels = channels;
  cap->ring = static_cast<SpscRing*>(ring);
  cap->packer = new Packer(cap->ring);
  if (dev_rate != target_rate)
    cap->resampler = new SincResampler(dev_rate, target_rate);

  const int bytes = fm->bytes;
  const int sample_fmt = fm->fmt;
  // Upsampling ratio can exceed 4x now that config negotiation may open a
  // device at its (low) max rate: size the resampler output from the real
  // dev->target ratio, not a fixed 4x (heap overflow otherwise).
  const size_t res_cap = static_cast<size_t>(
      (1024.0 + kTaps) *
          (static_cast<double>(target_rate) / static_cast<double>(dev_rate)) +
      kTaps + 16);
  cap->worker = std::thread([cap, bytes, sample_fmt, res_cap, nonblock]() {
    const unsigned long frames = 1024;
    std::vector<uint8_t> raw(frames * cap->channels * bytes);
    std::vector<float> mono(frames);
    std::vector<float> res(res_cap);
    while (!cap->stop.load(std::memory_order_relaxed)) {
      if (nonblock) {
        int ready = g_alsa.pcm_wait(cap->pcm, 100);  // bounded: stop stays live
        if (cap->stop.load(std::memory_order_relaxed)) break;
        if (ready == 0) continue;  // timeout: no data yet
        if (ready < 0 &&
            !(g_alsa.pcm_recover && g_alsa.pcm_recover(cap->pcm, ready, 1) == 0))
          break;
      }
      long got = g_alsa.pcm_readi(cap->pcm, raw.data(), frames);
      if (got == -11 /* -EAGAIN: nonblocking, nothing buffered */) continue;
      if (got == 0) continue;
      if (got < 0) {
        if (g_alsa.pcm_recover && g_alsa.pcm_recover(cap->pcm, (int)got, 1) == 0)
          continue;
        break;
      }
      mixdown_to_f32(raw.data(), got, (int)cap->channels, sample_fmt,
                     mono.data());
      if (cap->resampler) {
        int64_t n = cap->resampler->process(mono.data(), got, res.data(),
                                            static_cast<int64_t>(res.size()));
        if (n < 0) break;  // capacity bug: end the stream, don't corrupt
        cap->packer->append(res.data(), n);
      } else {
        cap->packer->append(mono.data(), got);
      }
    }
    cap->packer->close();
    cap->ring->closed.store(true, std::memory_order_release);
  });
  return cap;
}

// Backwards-compatible S16 entry point.
void* nta_alsa_start(const char* device, unsigned dev_rate, unsigned channels,
                     unsigned target_rate, void* ring) {
  return nta_alsa_start_fmt(device, dev_rate, channels, FMT_I16, target_rate,
                            ring);
}

void nta_alsa_stop(void* c) {
  auto* cap = static_cast<AlsaCapture*>(c);
  cap->stop.store(true, std::memory_order_relaxed);
  if (cap->worker.joinable()) cap->worker.join();
  if (cap->pcm) g_alsa.pcm_close(cap->pcm);
  delete cap;
}

}  // extern "C"

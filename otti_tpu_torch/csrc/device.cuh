// The device a launch runs on.  Each launch function of a kernel library
// takes the CUDA device of its tensors: a DeviceScope makes that device
// current for the launch (the stream the caller passes belongs to it) and
// gives the caller's back afterwards.  __constant__ memory and the
// occupancy a launch reads are per device, so a library's first launch on a
// device also runs the library's set-up there: it uploads the constants its
// init function stored on the host, once a device, under a std::once_flag.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

#define OTTI_MAX_DEVICES 64

// One library's set-up state on every device.
struct PerDevice {
  std::once_flag once[OTTI_MAX_DEVICES];
  int err[OTTI_MAX_DEVICES] = {};
};

class DeviceScope {
 public:
  // setup(dev) returns a CUDA error code; it runs once on each device, with
  // the device current, and its result is every later scope's there.
  template <class Setup>
  DeviceScope(int dev, PerDevice& state, Setup setup) : dev_(dev) {
    if (enter()) return;
    std::call_once(state.once[dev], [&] { state.err[dev] = setup(dev); });
    err = state.err[dev];
  }
  explicit DeviceScope(int dev) : dev_(dev) { enter(); }
  ~DeviceScope() {
    if (prev_ >= 0 && prev_ != dev_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

  int err = 0;  // nonzero: do not launch, return it

 private:
  int enter() {
    if (dev_ < 0 || dev_ >= OTTI_MAX_DEVICES) return err = (int)cudaErrorInvalidDevice;
    int cur = -1;
    if ((err = (int)cudaGetDevice(&cur))) return err;
    prev_ = cur;
    if (cur != dev_) err = (int)cudaSetDevice(dev_);
    return err;
  }

  int dev_, prev_ = -1;
};
